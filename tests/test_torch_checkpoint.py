"""The port's checkpoints (``repro_torch.checkpoint``) and the bridge's
inverse (``bridge.ref_tree``) on the CPU, against the JAX reference.

Mirrors ``tests/test_substrate.py``'s checkpoint tests (the pytree round
trip, the manager's GC / latest / restore, a train run resumed from a
checkpoint) and ``tests/test_resilience.py::
test_checkpoint_corruption_detected_and_fallback`` (with a duck-typed
stand-in for ``FaultPlan``, and once with the reference's own
``FaultPlan``, which the port takes duck-typed). Then: for the same
weights the port's ``.npz`` holds the reference ``save_pytree``'s keys,
shapes, dtypes, values and crc32s, and its JSON manifest the fields of the
reference's msgpack one; each package loads the other's file; a reference
-> port -> reference round trip through the bridge is bitwise for every
ported model. Exact comparisons throughout, but the resumed train run
(the reference test's atol 1e-6 / rtol 1e-5)."""

import json
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.checkpoint import io as ref_io  # noqa: E402
from repro.configs.registry import get_reduced as ref_reduced  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import protein as ref_prot  # noqa: E402
from repro.resilience.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    CheckpointManager, load_pytree,
                                    save_pytree, verify_checkpoint)
from repro_torch.checkpoint.io import manifest_step  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.core.payload import (FinetunePayload,  # noqa: E402
                                      ProteinPayload)
from repro_torch.models.common import trainable  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from test_torch_payload import payloads  # noqa: E402


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors here are small, and
    parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class ByteFlip:
    """A stand-in for the reference's ``FaultPlan``: flips one byte of the
    n-th checkpoint written after it, where the reference's plan would."""

    def __init__(self, at=1, seed=0):
        self.at, self.seed, self.seen = at, seed, 0

    def on_checkpoint_saved(self, path) -> bool:
        self.seen += 1
        if self.seen != self.at:
            return False
        with open(path, "r+b") as f:
            data = f.read()
            off = zlib.crc32(f"{self.seed}:{self.seen}".encode()) % len(data)
            f.seek(off)
            f.write(bytes([data[off] ^ 0xFF]))
        return True


# ---------------------------------------------------------------------------
# test_substrate.py's checkpoint tests, on the port
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "b": [torch.ones(4), {"c": torch.zeros((2, 2),
                                                   dtype=torch.int32)}]}


def test_pytree_roundtrip(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck")
    save_pytree(tree, path, step=5)
    out = load_pytree(tree, path)
    assert manifest_step(path) == 5
    for x, y in zip((tree["a"], *tree["b"][:1], tree["b"][1]["c"]),
                    (out["a"], *out["b"][:1], out["b"][1]["c"])):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_manager_gc_latest_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    state = {"w": torch.ones(3), "step": torch.zeros(())}
    for s in (1, 2, 3):
        mgr.save(s, {k: v + s for k, v in state.items()}, extra={"s": s},
                 block=True)
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000002.extra.json", "ckpt_00000002.manifest.json",
        "ckpt_00000002.npz", "ckpt_00000003.extra.json",
        "ckpt_00000003.manifest.json", "ckpt_00000003.npz", "latest.json"]
    restored, extra, step = mgr.restore(state)
    assert step == 3 and extra == {"s": 3}
    assert float(restored["w"][0]) == 4.0


def test_async_save_snapshots_at_the_call(tmp_path):
    """``save`` copies the state to host memory when called: changing the
    tensors afterwards, before the writer thread runs, changes nothing."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    w = torch.ones(8)
    mgr.save(1, {"w": w})
    w.add_(5.0)
    mgr.wait()
    restored, _, _ = mgr.restore({"w": torch.zeros(8)})
    assert torch.equal(restored["w"], torch.ones(8))


def test_train_checkpoint_resume_continues_identically(tmp_path):
    """Four finetune-loss train steps straight, against two, a checkpoint
    of the weights (a module) and the optimizer state, a restore, and two
    more: the same weights."""
    port = ProteinPayload(gen_cfg=get_reduced("progen-s").replace(
        compute_dtype="float32"), reduced=True, device="cpu")
    ft = FinetunePayload(port, lr=1e-3, steps=20)
    step_fn = ft._train_step()
    rng = np.random.default_rng(0)
    batches = [{k: torch.tensor(v) for k, v in {
        "backbones": rng.normal(size=(4, 8, 16)).astype(np.float32),
        "sequences": rng.integers(1, 20, size=(4, 10)).astype(np.int32),
        "weights": rng.uniform(0.2, 1.0, 4).astype(np.float32)}.items()}
        for _ in range(4)]

    def fresh():
        p = trainable(port.gen_params)
        return p, init_opt_state(dict(p.named_parameters()), ft.opt)

    p1, s1 = fresh()
    for b in batches:
        p1, s1, _ = step_fn(p1, s1, b)
    p2, s2 = fresh()
    for b in batches[:2]:
        p2, s2, _ = step_fn(p2, s2, b)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(2, {"params": p2, "opt": s2}, block=True)
    template = {"params": port.gen_params, "opt": s2}
    restored, _, _ = mgr.restore(template)
    p3 = trainable(restored["params"])
    s3 = restored["opt"]
    assert s3["count"] == 2
    s3["count"] = int(s3["count"])
    for b in batches[2:]:
        p3, s3, _ = step_fn(p3, s3, b)
    for (n, a), b in zip(p1.named_parameters(), p3.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# test_resilience.py's corruption test, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["stand-in", "reference FaultPlan"])
def test_checkpoint_corruption_detected_and_fallback(tmp_path, plan):
    def new_plan(seed):
        if plan == "stand-in":
            return ByteFlip(at=1, seed=seed)
        return FaultPlan([FaultSpec(op="corrupt_checkpoint", at=1)],
                         seed=seed)

    state1 = {"w": torch.arange(32, dtype=torch.float32),
              "b": torch.ones(5)}
    state2 = {"w": torch.arange(32, dtype=torch.float32) * 2,
              "b": torch.ones(5) * 3}
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    mgr.save(1, state1, extra={"step": 1}, block=True)
    mgr.save(2, state2, extra={"step": 2}, block=True)

    assert new_plan(3).on_checkpoint_saved(mgr._base(2) + ".npz")
    assert not verify_checkpoint(mgr._base(2))
    assert verify_checkpoint(mgr._base(1))

    template = {"w": torch.zeros(32), "b": torch.zeros(5)}
    with pytest.raises(CheckpointCorruptError):
        load_pytree(template, mgr._base(2))
    restored, extra, step = mgr.restore(template)
    assert step == 1 and extra == {"step": 1}
    assert torch.equal(restored["w"], state1["w"])
    # corrupt the only remaining copy too: restore must raise, not lie
    assert new_plan(9).on_checkpoint_saved(mgr._base(1) + ".npz")
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(template)


def test_save_pytree_fault_plan_seam(tmp_path):
    plan = ByteFlip(at=1)
    base = str(tmp_path / "ckpt")
    save_pytree({"w": torch.ones(4)}, base, step=0, fault_plan=plan)
    assert plan.seen == 1
    assert not verify_checkpoint(base)


@pytest.mark.parametrize("damage", ["truncated npz", "garbled manifest",
                                    "checksum"])
def test_damaged_checkpoint_raises(tmp_path, damage):
    """A truncated ``.npz``, a manifest that is not JSON and an array whose
    bytes no longer match its crc32 (rewritten consistently, so only the
    checksum can tell) all raise ``CheckpointCorruptError``."""
    base = str(tmp_path / "ck")
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    save_pytree(tree, base, step=1)
    if damage == "truncated npz":
        with open(base + ".npz", "r+b") as f:
            f.truncate(os.path.getsize(base + ".npz") // 2)
    elif damage == "garbled manifest":
        with open(base + ".manifest.json", "w") as f:
            f.write("{not json")
    else:
        np.savez(base + ".npz", w=np.arange(64, dtype=np.float32) + 1)
    with pytest.raises(CheckpointCorruptError):
        load_pytree(tree, base)
    if damage != "garbled manifest":
        assert not verify_checkpoint(base)


# ---------------------------------------------------------------------------
# the same files as the reference's
# ---------------------------------------------------------------------------

def _progen_pair():
    ref, port = payloads("float32")
    return ref.gen_params, port.gen_params


def _pytree_pair():
    return ({"a": jnp.arange(6).reshape(2, 3).astype(jnp.bfloat16),
             "b": [jnp.ones(4), {"c": jnp.zeros((2, 2), jnp.int32)}]},
            _tree())


@pytest.mark.parametrize("pair", [_progen_pair, _pytree_pair],
                         ids=["progen-s reduced", "bf16 pytree"])
def test_port_npz_holds_the_reference_arrays(tmp_path, pair):
    """For the same values, the port's ``.npz`` holds the reference's keys,
    shapes, dtypes, bytes and crc32s, and its manifest the reference
    manifest's fields, treedef included."""
    ref_tree, port_tree = pair()
    ref_io.save_pytree(ref_tree, str(tmp_path / "ref"), step=4)
    save_pytree(port_tree, str(tmp_path / "port"), step=4)
    with np.load(tmp_path / "ref.npz") as r, \
            np.load(tmp_path / "port.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            assert r[k].shape == p[k].shape and r[k].dtype == p[k].dtype, k
            assert r[k].tobytes() == p[k].tobytes(), k
            assert zlib.crc32(r[k].tobytes()) == zlib.crc32(p[k].tobytes())
    with open(tmp_path / "ref.manifest", "rb") as f:
        want = msgpack.unpackb(f.read())
    with open(tmp_path / "port.manifest.json") as f:
        got = json.load(f)
    assert got == want


def test_each_package_loads_the_others_checkpoint(tmp_path):
    """A reference checkpoint restores into a port module (no JSON
    manifest: it loads unchecked, as a legacy checkpoint does in the
    reference), and a port checkpoint into the reference's pytree."""
    ref_params, port_params = _progen_pair()
    ref_io.save_pytree(ref_params, str(tmp_path / "ref"), step=1)
    got = load_pytree(port_params, str(tmp_path / "ref"))
    assert type(got) is type(port_params) and got is not port_params
    for (n, a), b in zip(port_params.named_parameters(), got.parameters()):
        assert torch.equal(a, b) and not b.requires_grad, n
    save_pytree(port_params, str(tmp_path / "port"), step=1)
    back = ref_io.load_pytree(ref_params, str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(ref_params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ref_models():
    key = jax.random.PRNGKey(3)
    return {
        "progen-s": lambda: (ref_prot.init_progen(
            key, ref_reduced("progen-s")), bridge.progen_from_ref,
            ref_reduced("progen-s")),
        "foldscore-m": lambda: (ref_prot.init_foldscore(
            key, ref_reduced("foldscore-m")), bridge.foldscore_from_ref,
            ref_reduced("foldscore-m")),
        "rwkv6-7b": lambda: (ref_lm.init_lm(key, ref_reduced("rwkv6-7b")),
                             bridge.lm_from_ref, ref_reduced("rwkv6-7b")),
        "recurrentgemma-2b": lambda: (
            ref_lm.init_lm(key, ref_reduced("recurrentgemma-2b")),
            bridge.lm_from_ref, ref_reduced("recurrentgemma-2b")),
    }


@pytest.mark.parametrize("arch", ["progen-s", "foldscore-m", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_bridge_round_trip_is_bitwise(arch):
    """reference -> port -> reference gives back every leaf bitwise, under
    the reference's own ``_flatten`` keys; ``module_from_ref`` rebuilds the
    same module."""
    params, to_port, cfg = _ref_models()[arch]()
    params = jax.tree.map(np.asarray, params)
    module = to_port(params, bridge._port_cfg(cfg))
    back = bridge.ref_tree(module)
    want, got = ref_io._flatten(params), ref_io._flatten(back)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(
            want[k], got[k]), k
    again = bridge.module_from_ref(back, module)
    for a, b in zip(module.parameters(), again.parameters()):
        assert torch.equal(a, b)
