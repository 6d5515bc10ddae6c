"""Param-set namespaces of the port's payload, on the CPU: the foldscore-m
config, a namespace's seeded weights (``zlib.crc32`` of its name, the same
in every process), ``ParamStore.publish`` retiring a version and evicting
its device copies per namespace behind a tombstone, launches counted by
namespace, and the "multimer" (foldscore-m) scorer and "binder" generator
against the reference's on the same weights (carried across by
``bridge.payload_namespaces_from_ref``): ``predict_batch`` exact and
masked to the reference tests' 1e-5 in fp32, ``generate_batch`` token for
token on the reference's draws."""

import dataclasses
import os
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.core.payload import ProteinPayload  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.models import protein as prot  # noqa: E402
from repro_torch.runtime.allocator import SubMesh  # noqa: E402
from test_torch_campaign import NoisedPayload  # noqa: E402
from test_torch_payload import _RefMesh, payloads  # noqa: E402
from test_torch_sampler import backbones  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = SubMesh((torch.device("cpu"),))
META = torch.device("meta")


def f32(get, name):
    return dataclasses.replace(get(name), compute_dtype="float32")


def test_foldscore_m_reduced_config_is_the_references():
    cfg = get_reduced("foldscore-m")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_get_reduced("foldscore-m"))
    assert (cfg.name, cfg.n_layers, cfg.d_ff) == ("foldscore-m", 3, 128)


def test_foldscore_m_full_config_builds_where_the_reference_raises():
    """The reference derives foldscore-m from foldscore-s with 12 layers but
    keeps the base's materialized 8-layer segment plan, so its full-width
    config raises on construction (a reference fault, ROADMAP Queue 3).
    The port's clears the plan: foldscore-s with 12 layers and d_ff 1536,
    every other field the reference's."""
    with pytest.raises(AssertionError, match="segments describe 8 layers"):
        ref_get_config("foldscore-m")
    cfg = dataclasses.asdict(get_config("foldscore-m"))
    base = dataclasses.asdict(ref_get_config("foldscore-s"))
    assert cfg == dict(base, name="foldscore-m", n_layers=12, d_ff=1536,
                       segments=((("attn",), 12),))


def _digest(module):
    return float(sum(p.double().sum() for p in module.parameters()))


def test_namespace_weights_come_from_crc32_of_the_name_in_any_process():
    """``add_generator("binder")`` / ``add_scorer("multimer")`` draw their
    weights from ``init_progen`` / ``init_foldscore`` seeded ``crc32(name)
    & 0xFFFF``; another process, with another string-hash salt, draws the
    same."""
    pp = ProteinPayload(reduced=True, device="cpu")
    gen = pp.add_generator("binder").current()[1]
    cfg, scorer = pp.add_scorer("multimer")
    assert cfg.name == "foldscore-m" and pp.gen_cfgs["binder"].name == \
        "progen-s"
    for module, want in (
            (gen, prot.init_progen(get_reduced("progen-s"),
                                   zlib.crc32(b"binder") & 0xFFFF, "cpu")),
            (scorer, prot.init_foldscore(get_reduced("foldscore-m"),
                                         zlib.crc32(b"multimer") & 0xFFFF,
                                         "cpu"))):
        for a, b in zip(module.parameters(), want.parameters()):
            assert torch.equal(a, b)
    code = ("from repro_torch.core.payload import ProteinPayload\n"
            "pp = ProteinPayload(reduced=True, device='cpu')\n"
            "g = pp.add_generator('binder').current()[1]\n"
            "f = pp.add_scorer('multimer')[1]\n"
            "print(repr(sum(float(p.double().sum()) for p in "
            "g.parameters())), repr(sum(float(p.double().sum()) for p in "
            "f.parameters())))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONHASHSEED="12345")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert [float(v) for v in out] == [
        sum(float(p.double().sum()) for p in m.parameters())
        for m in (gen, scorer)]
    assert pp.add_generator("binder").current()[1] is gen   # idempotent


def test_publish_retires_and_evicts_per_namespace_with_a_tombstone():
    pp = ProteinPayload(reduced=True, device="cpu")
    store = pp.add_generator("binder")
    ver0, w0 = store.current()
    copy0 = pp._params_on(("gen", "binder", ver0), w0, META)
    default = pp._params_on(("gen", "default", 0), pp.gen_params, META)
    assert pp._params_on(("gen", "binder", ver0), w0, META) is copy0
    w1 = prot.init_progen(pp.gen_cfgs["binder"], 1, "cpu")
    assert store.publish(w1) == 1 and store.versions() == [0, 1]
    copy1 = pp._params_on(("gen", "binder", 1), w1, META)
    assert store.publish(prot.init_progen(pp.gen_cfgs["binder"], 2,
                                          "cpu")) == 2
    assert store.versions() == [1, 2]                   # keep=2: 0 retired
    keys = {k[0] for k in pp._cache}
    assert ("gen", "binder", 0) not in keys
    assert ("gen", "binder", 1) in keys and ("gen", "default", 0) in keys
    assert pp._params_on(("gen", "default", 0), pp.gen_params,
                         META) is default                 # untouched
    assert pp._params_on(("gen", "binder", 1), w1, META) is copy1
    # tombstone: a dispatch still holding version 0 gets a copy, uncached
    late = pp._params_on(("gen", "binder", 0), w0, META)
    assert late is not copy0
    assert ("gen", "binder", 0) not in {k[0] for k in pp._cache}
    assert pp.param_store.versions() == [0]             # other namespace


def test_launches_are_counted_by_the_running_threads_namespace():
    _cuda.reset_launches()
    seen = {}

    def run(ns, n):
        with _cuda.namespace(ns):
            for _ in range(n):
                _cuda.check_launch("flash_attention_bhsd", 0, "seq_bf16")
            with _cuda.namespace("binder"):
                _cuda.check_launch("flash_attention_bhsd", 0, "decode")
            seen[ns] = True

    threads = [threading.Thread(target=run, args=(ns, n))
               for ns, n in (("multimer", 12), ("default", 8))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    _cuda.check_launch("rglru_btc", 0)                 # outside any namespace
    try:
        assert seen == {"multimer": True, "default": True}
        by_ns = {ns: {k: v for k, v in c.items() if v}
                 for ns, c in _cuda.by_namespace.items()}
        assert by_ns == {"multimer": {"flash_attention_bhsd": 12},
                         "default": {"flash_attention_bhsd": 8},
                         "binder": {"flash_attention_bhsd": 2}}
        assert _cuda.launches["flash_attention_bhsd"] == 22
    finally:
        _cuda.reset_launches()
    assert _cuda.by_namespace == {}


def test_tally_counts_only_the_launches_of_its_own_thread():
    """``tally`` sees the launches its thread makes inside the block, by
    kernel and form, nested tallies each; another thread's launches and
    launches after the block stay out."""
    _cuda.reset_launches()
    inner_seen = {}

    def other():
        for _ in range(5):
            _cuda.check_launch("flash_attention_bhsd", 0, "decode")

    try:
        with _cuda.tally() as outer:
            t = threading.Thread(target=other)
            t.start()
            for _ in range(3):
                _cuda.check_launch("flash_attention_bhsd", 0, "seq_bf16")
            with _cuda.tally() as inner:
                _cuda.check_launch("wkv6_bhtk", 0, "prefill")
            inner_seen.update(inner)
            t.join(timeout=30)
        _cuda.check_launch("rglru_btc", 0)
        assert outer == {"flash_attention_bhsd": 3,
                         ("flash_attention_bhsd", "seq_bf16"): 3,
                         "wkv6_bhtk": 1, ("wkv6_bhtk", "prefill"): 1}
        assert inner_seen == {"wkv6_bhtk": 1, ("wkv6_bhtk", "prefill"): 1}
        assert _cuda.launches["flash_attention_bhsd"] == 8
        assert _cuda.forms["flash_attention_bhsd"]["decode"] == 5
    finally:
        _cuda.reset_launches()


@pytest.fixture(scope="module")
def multimer_payloads():
    ref, _ = payloads("float32")
    ref.add_scorer("multimer", cfg=f32(ref_get_reduced, "foldscore-m"))
    ref.add_generator("binder", cfg=f32(ref_get_reduced, "progen-s"))
    port = NoisedPayload(reduced=True, device="cpu")
    bridge.payload_namespaces_from_ref(ref, port)
    return ref, port


def test_bridge_carries_every_namespace(multimer_payloads):
    ref, port = multimer_payloads
    assert set(port.gen_stores) >= {"default", "binder"}
    assert set(port.fold_sets) >= {"default", "multimer"}
    for ns, store in ref.gen_stores.items():
        assert port.gen_stores[ns].version == store.version
        assert port.gen_cfgs[ns].compute_dtype == "float32"
    assert port.param_store is port.gen_stores["default"]
    cfg, scorer = port.fold_sets["multimer"]
    assert cfg.name == "foldscore-m" and len(scorer.layers) == 3


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "masked"])
def test_foldscore_m_predict_batch_matches_reference(multimer_payloads,
                                                     masked):
    ref, port = multimer_payloads
    rng = np.random.default_rng(21)
    R, L = 3, 20
    payload = {"sequences": rng.integers(1, 21, size=(R, L)).astype(np.int32),
               "target": rng.normal(size=(R, 16)).astype(np.float32),
               "receptor_len": 14, "params": "multimer"}
    if masked:
        payload["seq_lens"] = np.asarray([20, 17, 12], np.int32)
        payload["chain_splits"] = np.asarray([14, 11, 8], np.int32)
    want = ref.predict_batch(_RefMesh(), payload)
    got = port.predict_batch(CPU, payload)
    assert got["batch"] == want["batch"]
    for g, w in zip(got["rows"], want["rows"]):
        assert_allclose([g[k] for k in w], [w[k] for k in w],
                        atol=1e-5, rtol=1e-5)
    default = port.predict_batch(CPU, dict(payload, params=None))
    assert default["rows"] != got["rows"]       # another model ran


def test_binder_generator_matches_reference(multimer_payloads):
    ref, port = multimer_payloads
    payload = {"backbones": backbones(np.random.default_rng(22), 2),
               "seeds": [5, 9], "n": 3, "length": 6, "params": "binder",
               "row_lens": [6, 4]}
    want = ref.generate_batch(_RefMesh(), payload)
    got = port.generate_batch(CPU, payload)     # the reference's draws
    assert got["gen_version"] == want["gen_version"]
    for (gs, gl), (ws, wl) in zip(got["rows"], want["rows"]):
        np.testing.assert_array_equal(gs, ws)
        assert_allclose(gl, wl, atol=1e-4, rtol=0)
