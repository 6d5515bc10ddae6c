"""Mixture-of-experts and qk-norm, port vs the JAX reference on the CPU:
qwen3-moe-30b-a3b (every layer MoE, top-8 of 128 experts, qk-norm) and
llama4-maverick-400b-a17b (attn and MoE layers interleaved, top-1 and a
shared expert, qk-norm, bf16 weights), reduced.

Both sides are built from the reference's own seeded ``init_lm`` through
``repro_torch.bridge``; inputs from numpy seeds; fp32 compute unless said.
The reference runs as its own tests run it (``attn_impl`` "xla", on the
CPU). Routing is discrete: a near tie between two experts flips the choice
when the hidden states differ by rounding, so routing, logits and the
router's aux values are held in fp32, where the reference's own MoE tests
hold them (``tests/test_models.py``). Tolerances: the MoE FFN's output to
2e-5 and its aux values to 1e-5 relative (atol 1e-7: a mean of ones, the
kept share, rounds to 1 + 3e-8 in the reference), capacity against dense
with no drop to 1e-4 (the reference's test), the model to 1e-5 in fp32,
prefill + decode against the full forward to 5e-4 with ``moe_impl="dense"``
(the reference's invariant: the capacity form routes a prompt's tokens in
one group but a decode step's alone, so only the dense form makes the two
agree), gradients to 2e-5 of each leaf's largest."""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import attention, common, lm, moe  # noqa: E402
from repro_torch.models.common import trainable  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
FP32 = dict(atol=1e-5, rtol=1e-5)
AUX = dict(rtol=1e-5, atol=1e-7)
# test_models.py's ranges: (total, active)
RANGES = {"qwen3-moe-30b-a3b": ((28e9, 33e9), (2e9, 4.5e9)),
          "llama4-maverick-400b-a17b": ((360e9, 430e9), (12e9, 20e9))}
# the block position of each arch's first MoE layer, and its port layer
MOE_LAYER = {"qwen3-moe-30b-a3b": ("0_moe", 0),
             "llama4-maverick-400b-a17b": ("1_moe", 1)}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors are small, and parallel
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np32(x):
    return np.asarray(x, np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def cfgs(arch, dtype="float32", **kw):
    """(reference cfg, port cfg) of the reduced config at ``dtype``."""
    return (dataclasses.replace(ref_get_reduced(arch), compute_dtype=dtype,
                                **kw),
            get_reduced(arch).replace(compute_dtype=dtype, **kw))


_PARAMS = {}


def ref_params(arch):
    """The reference's seeded reduced weights, numpy leaves."""
    if arch not in _PARAMS:
        init = jax.jit(ref_lm.init_lm, static_argnums=(1,))
        _PARAMS[arch] = jax.tree.map(np.asarray, init(
            jax.random.PRNGKey(0), ref_get_reduced(arch)))
    return _PARAMS[arch]


def both(arch, dtype="float32", **kw):
    """(reference cfg, reference params as jax arrays, port cfg, port LM)."""
    rcfg, pcfg = cfgs(arch, dtype, **kw)
    return (rcfg, jax.tree.map(jnp.asarray, ref_params(arch)), pcfg,
            bridge.lm_from_ref(ref_params(arch), pcfg))


def moe_pair(arch, **kw):
    """(reference cfg, the first MoE layer's reference params, port cfg,
    its port ``Moe``)."""
    rcfg, pcfg = cfgs(arch, **kw)
    key, idx = MOE_LAYER[arch]
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      ref_params(arch)["segments"][0][key]["moe"])
    return rcfg, rp, pcfg, bridge.lm_from_ref(ref_params(arch),
                                               pcfg).layers[idx].moe


def make_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(1, cfg.vocab_size, size=(B, S))
            .astype(np.int32),
            "targets": rng.integers(1, cfg.vocab_size, size=(B, S))
            .astype(np.int32)}


def as_ref(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_port(b):
    return {k: t(v) for k, v in b.items()}


def close_aux(got, want):
    assert set(got) == set(want) == set(moe.AUX_KEYS)
    for k in want:
        assert_allclose(float(got[k]), float(want[k]), **AUX, err_msg=k)


# ---------------------------------------------------------------------------
# configs and structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_configs_match_reference(arch, reduced):
    ref = (ref_get_reduced if reduced else ref_get_config)(arch)
    port = (get_reduced if reduced else get_config)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert len(port.layer_kinds) == ref.n_layers


def _ref_shapes(tree, cfg):
    """Reference leaves by the port's parameter names, each segment split
    per layer (the leading ``repeats`` axis dropped)."""
    out = {}

    def walk(node, prefix, stacked):
        for name, sub in node.items():
            if isinstance(sub, dict):
                walk(sub, f"{prefix}{name}.", stacked)
            else:
                out[f"{prefix}{name}"] = (tuple(sub.shape[1:] if stacked
                                                else sub.shape), sub.dtype)

    tree = dict(tree)
    segments = tree.pop("segments")
    walk(tree, "", False)
    idx = 0
    for seg, (kinds, reps) in zip(segments, cfg.segments):
        for _ in range(reps):
            for i, kind in enumerate(kinds):
                walk(seg[f"{i}_{kind}"], f"layers.{idx}.", True)
                idx += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_structure_on_meta(arch):
    """The full-width model on the meta device: the reference's parameter
    names, shapes and dtypes (``jax.eval_shape`` of its ``init_lm``:
    llama4's weights bf16, its routers fp32), everything outside the norms
    (the qk-norm scales included) equal to ``param_count``, the totals in
    test_models.py's ranges."""
    cfg = get_config(arch)
    with torch.device("meta"):
        model = lm.LM(cfg)
    ref = jax.eval_shape(lambda: ref_lm.init_lm(jax.random.PRNGKey(0),
                                                ref_get_config(arch)))
    want = {n: (s, np.dtype(dt).name) for n, (s, dt) in
            _ref_shapes(ref, cfg).items()}
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in model.named_parameters()}
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    no_norm = sum(p.numel() for name, p in model.named_parameters()
                  if "norm" not in name)
    assert no_norm == cfg.param_count()
    (lo, hi), (alo, ahi) = RANGES[arch]
    assert lo <= n <= hi, n
    assert alo <= cfg.active_param_count() <= ahi
    assert model.layers[0].attn.q_norm.shape == (cfg.head_dim,)


def test_non_fp32_weights_are_drawn_in_slices(monkeypatch):
    """``dense_init``: an fp32 weight is one draw, unchanged (every model
    served before llama4 keeps its weights bit for bit); a bf16 one is
    drawn ``DRAW_SLICE`` elements of its leading axis at a time, each
    slice the fp32 draw's rounding, so no fp32 copy of the whole weight
    is made."""
    g = torch.Generator().manual_seed(3)
    whole = common.dense_init(g, (6, 4, 5), 4)
    want = torch.randn((6, 4, 5), generator=torch.Generator().manual_seed(3))
    assert torch.equal(whole, want.mul_(0.5))
    monkeypatch.setattr(common, "DRAW_SLICE", 40)      # two rows a slice
    got = common.dense_init(torch.Generator().manual_seed(3), (6, 4, 5), 4,
                            torch.bfloat16)
    g = torch.Generator().manual_seed(3)
    rows = [torch.randn((2, 4, 5), generator=g).mul_(0.5) for _ in range(3)]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.cat(rows).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

def _moe_input(cfg, seed=2, B=2, S=64):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_form_matches_reference(arch):
    """``moe_fwd_dense``: y to 2e-5, the three aux values to 1e-5."""
    rcfg, rp, pcfg, port = moe_pair(arch, moe_impl="dense")
    x = _moe_input(pcfg)
    want_y, want_aux = ref_moe.moe_fwd(rp, jnp.asarray(x), rcfg)
    got_y, got_aux = moe.moe_fwd(port, t(x), pcfg)
    assert_allclose(got_y.numpy(), np32(want_y), atol=2e-5, rtol=2e-5)
    close_aux(got_aux, want_aux)
    assert float(got_aux["moe_drop_frac"]) == 0.0


class _VmapRecorder:
    """``jax`` as ``repro.models.moe`` sees it, its ``vmap`` recording each
    vmapped call's arguments and results: the capacity form's first is
    ``rank_in_expert`` over the token-major expert ids (ranks, counts), its
    second the dispatch scatter, whose ``slot`` argument marks a dropped
    choice E*C."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, f, *a, **kw):
        g = jax.vmap(f, *a, **kw)

        def run(*args):
            out = g(*args)
            self.calls.append((args, out))
            return out
        return run


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
def test_moe_capacity_form_matches_reference(arch, cf, monkeypatch):
    """The capacity form at capacity factors 0.25 (drops), 1.25 (the
    configs') and 8.0 (no drop): y to 2e-5, the aux values to 1e-5, and
    the routing element for element: the token-major expert ids, each
    expert's count, each choice's slot and the keep mask (rank < C) equal
    the reference's. With no drop the form equals the dense one to 1e-4
    (the reference's ``test_moe_capacity_vs_dense_no_drop``)."""
    rcfg, rp, pcfg, port = moe_pair(arch, moe_capacity_factor=cf)
    x = _moe_input(pcfg)
    rec = _VmapRecorder()
    monkeypatch.setattr(ref_moe, "jax", rec)
    want_y, want_aux = ref_moe.moe_fwd(rp, jnp.asarray(x), rcfg)
    monkeypatch.undo()
    got_y, got_aux = moe.moe_fwd(port, t(x), pcfg)
    assert_allclose(got_y.numpy(), np32(want_y), atol=2e-5, rtol=2e-5)
    close_aux(got_aux, want_aux)

    (ref_eid,), (_, ref_counts) = rec.calls[0]
    (_, ref_slot, _), _ = rec.calls[1]
    E, Ng = pcfg.moe_experts, x.shape[1]
    C = moe.capacity(Ng, pcfg)
    assert C == ref_moe.capacity(Ng, rcfg)
    _, _, _, idx = moe._route(port, t(x), pcfg)
    eid, keep, slot, counts = moe.dispatch_slots(idx, E, C)
    np.testing.assert_array_equal(eid.numpy(), np.asarray(ref_eid))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(ref_slot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_slot) < E * C)
    drop = float(got_aux["moe_drop_frac"])
    assert drop == pytest.approx(1.0 - float(keep.float().mean()))
    if cf == 0.25:
        assert drop > 0.0
    if cf == 8.0:
        assert drop == 0.0
        dense_y, _ = moe.moe_fwd_dense(port, t(x), pcfg)
        assert float((got_y - dense_y).abs().max()) < 1e-4


def test_top_k_ties_take_the_lower_expert_first():
    """Equal router probabilities: the port's stable descending sort picks
    the lower expert index first, as ``jax.lax.top_k`` does."""
    _, pcfg = cfgs("qwen3-moe-30b-a3b")
    probs = np.asarray([[0.1, 0.3, 0.3, 0.05, 0.3, 0.1, 0.05, 0.1]],
                       np.float32)
    want_g, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got = torch.sort(t(probs), dim=-1, descending=True, stable=True)
    assert got.indices[0, :3].tolist() == np.asarray(want_i)[0].tolist() \
        == [1, 2, 4]

    class _Router:            # logits whose softmax ties exactly
        router = torch.eye(pcfg.d_model, pcfg.moe_experts)
    x = torch.zeros(1, pcfg.d_model)
    x[0, [1, 4, 6]] = 3.0
    _, _, gate, idx = moe._route(_Router, x, pcfg.replace(moe_top_k=2))
    assert idx.tolist() == [[1, 4]]
    assert gate.tolist() == [[0.5, 0.5]]


def test_capacity_matches_reference():
    for arch in ARCHS:
        rcfg, pcfg = cfgs(arch)
        for n in (1, 7, 64, 512):
            for cf in (0.25, 1.25, 8.0):
                assert moe.capacity(n, pcfg.replace(
                    moe_capacity_factor=cf)) == ref_moe.capacity(
                    n, dataclasses.replace(rcfg, moe_capacity_factor=cf))


# ---------------------------------------------------------------------------
# qk-norm attention
# ---------------------------------------------------------------------------

def _attn_pair(arch="qwen3-moe-30b-a3b"):
    rcfg, pcfg = cfgs(arch)
    key, idx = MOE_LAYER[arch]
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      ref_params(arch)["segments"][0][key]["attn"])
    assert set(rp) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    port = bridge.lm_from_ref(ref_params(arch), pcfg).layers[idx].attn
    # scales away from ones, so that a missing norm shows
    rng = np.random.default_rng(8)
    for name in ("q_norm", "k_norm"):
        s = (1.0 + 0.3 * rng.normal(size=pcfg.head_dim)).astype(np.float32)
        rp[name] = jnp.asarray(s)
        getattr(port, name).data.copy_(t(s))
    return rcfg, rp, pcfg, port


def test_qk_norm_attn_fwd_prefill_and_decode_match_reference():
    """qk-norm (q and k RMS-normed per head before RoPE, scales away from
    ones): the full-sequence forward, the prompt prefill into a cache and
    four decode steps over it, against the reference's."""
    rcfg, rp, pcfg, port = _attn_pair()
    rng = np.random.default_rng(9)
    B, S, S0 = 2, 10, 6
    x = rng.normal(size=(B, S, pcfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    want = ref_attn.attn_fwd(rp, jnp.asarray(x), jnp.asarray(pos), rcfg)
    got = attention.attn_fwd(port, t(x), t(pos), pcfg)
    assert_allclose(got.numpy(), np32(want), **FP32)

    r_cache = ref_attn.init_cache(rcfg, B, S)
    r_out, r_cache = ref_attn.attn_prefill(
        rp, jnp.asarray(x[:, :S0]), jnp.asarray(pos[:S0]), rcfg,
        cache=r_cache)
    p_cache = attention.init_cache(pcfg, B, S)
    p_out, p_cache = attention.attn_prefill(
        port, t(x[:, :S0]), t(pos[:S0]), pcfg, cache=p_cache)
    assert_allclose(p_out.numpy(), np32(r_out), **FP32)
    for i in range(S0, S):
        r_out, r_cache = ref_attn.attn_decode(
            rp, jnp.asarray(x[:, i:i + 1]), i, rcfg, cache=r_cache)
        p_out, p_cache = attention.attn_decode(
            port, t(x[:, i:i + 1]), i, pcfg, cache=p_cache)
        assert_allclose(p_out.numpy(), np32(r_out), **FP32)
    assert_allclose(p_cache["k"].numpy(), np32(r_cache["k"]), **FP32)


def test_qk_norm_attention_in_bf16_matches_reference():
    """bf16 compute, where routing would flip at near ties and so is not
    compared: qk-norm attention alone (llama4's first layer, bf16
    activations, the norms in fp32 inside), the full forward and four
    decode steps after a 6-token prefill, to 2e-2 (the repo's bf16
    tolerance)."""
    rcfg, pcfg = cfgs("llama4-maverick-400b-a17b", "bfloat16")
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]), ref_params(
        "llama4-maverick-400b-a17b")["segments"][0]["0_attn"]["attn"])
    port = bridge.lm_from_ref(ref_params("llama4-maverick-400b-a17b"),
                              pcfg).layers[0].attn
    rng = np.random.default_rng(11)
    B, S, S0 = 2, 10, 6
    x = np32(jnp.asarray(rng.normal(size=(B, S, pcfg.d_model)),
                         jnp.bfloat16))
    xr, xp = jnp.asarray(x, jnp.bfloat16), t(x).to(torch.bfloat16)
    pos = np.arange(S)
    bf16 = dict(atol=2e-2, rtol=2e-2)
    want = ref_attn.attn_fwd(rp, xr, jnp.asarray(pos), rcfg)
    got = attention.attn_fwd(port, xp, t(pos), pcfg)
    assert got.dtype == torch.bfloat16
    assert_allclose(got.float().numpy(), np32(want), **bf16)
    r_cache = ref_attn.init_cache(rcfg, B, S)
    _, r_cache = ref_attn.attn_prefill(rp, xr[:, :S0], jnp.asarray(pos[:S0]),
                                       rcfg, cache=r_cache)
    p_cache = attention.init_cache(pcfg, B, S)
    _, p_cache = attention.attn_prefill(port, xp[:, :S0], t(pos[:S0]), pcfg,
                                        cache=p_cache)
    for i in range(S0, S):
        r_out, r_cache = ref_attn.attn_decode(rp, xr[:, i:i + 1], i, rcfg,
                                              cache=r_cache)
        p_out, p_cache = attention.attn_decode(port, xp[:, i:i + 1], i,
                                               pcfg, cache=p_cache)
        assert_allclose(p_out.float().numpy(), np32(r_out), **bf16)


def test_qk_norm_cross_path_matches_reference():
    """The cross path with qk-norm (no config pairs them today; the
    reference normalizes there, so the port does): the cross cache's keys
    normed (``init_cross_cache``), the cross prefill's queries and keys,
    and one cross decode read, whose query is normed too."""
    rcfg, rp, pcfg, port = _attn_pair()
    rng = np.random.default_rng(10)
    enc = rng.normal(size=(2, 7, pcfg.d_model)).astype(np.float32)
    r_cache = ref_attn.init_cross_cache(rp, jnp.asarray(enc), rcfg)
    p_cache = attention.init_cross_cache(port, t(enc), pcfg)
    for name in ("k", "v"):
        assert_allclose(p_cache[name].numpy(), np32(r_cache[name]), **FP32)
    xs = rng.normal(size=(2, 4, pcfg.d_model)).astype(np.float32)
    want = ref_attn.attn_fwd(rp, jnp.asarray(xs), None, rcfg, causal=False,
                             kv_x=jnp.asarray(enc), rope=False)
    got, _ = attention.cross_prefill(port, t(xs), t(enc), pcfg)
    assert_allclose(got.numpy(), np32(want), **FP32)
    x = rng.normal(size=(2, 1, pcfg.d_model)).astype(np.float32)
    r_out, _ = ref_attn.attn_decode(rp, jnp.asarray(x), 3, rcfg,
                                    cache=r_cache, cross=True)
    p_out, _ = attention.attn_decode(port, t(x), 3, pcfg, cache=p_cache,
                                     cross=True)
    assert_allclose(p_out.numpy(), np32(r_out), **FP32)


# ---------------------------------------------------------------------------
# the model: forward, prefill + decode, the loss, the bridge
# ---------------------------------------------------------------------------

def _local_moe(cfg):
    """A reduced stack of two ``attn_local_moe`` layers, window 4."""
    return dataclasses.replace(cfg, segments=((("attn_local_moe",), 2),),
                               attn_window=4)


_LOCAL = {}


def local_both():
    """(reference cfg, params, port cfg, port LM) of ``_local_moe`` of
    reduced qwen3, the reference's own seeded weights."""
    if not _LOCAL:
        rcfg, pcfg = cfgs("qwen3-moe-30b-a3b")
        rcfg, pcfg = _local_moe(rcfg), _local_moe(pcfg)
        rp = jax.tree.map(np.asarray, jax.jit(
            ref_lm.init_lm, static_argnums=(1,))(
            jax.random.PRNGKey(1), _local_moe(ref_get_reduced(
                "qwen3-moe-30b-a3b"))))
        _LOCAL["v"] = (rcfg, rp, pcfg)
    rcfg, rp, pcfg = _LOCAL["v"]
    return (rcfg, jax.tree.map(jnp.asarray, rp), pcfg,
            bridge.lm_from_ref(rp, pcfg))


def _pick(arch):
    return local_both() if arch == "attn_local_moe" else both(arch)


@pytest.mark.parametrize("arch", ARCHS + ("attn_local_moe",))
def test_lm_logits_and_aux_match_reference(arch):
    """The full forward's logits (capacity form) to 1e-5 and the aux
    values summed over the layers to 1e-5 relative; the local-window MoE
    stack too (10 tokens past its window of 4)."""
    rcfg, rp, pcfg, port = _pick(arch)
    b = make_batch(pcfg, 2, 10, seed=4)
    want, want_aux = ref_lm.lm_logits(rp, as_ref(b), rcfg)
    x, got_aux = lm.lm_hidden(port, as_port(b), pcfg)
    got = lm.lm_logits(port, as_port(b), pcfg)
    assert got.shape == want.shape == (2, 10, pcfg.padded_vocab)
    assert_allclose(got.numpy(), np32(want), **FP32)
    close_aux(got_aux, want_aux)


def _ref_serve(rp, b, rcfg, toks, S0, cache_len):
    pb = dict(as_ref(b), inputs=jnp.asarray(toks[:, :S0]))
    logits, caches, tt = ref_lm.prefill(rp, pb, rcfg, cache_len=cache_len)
    out = [np32(logits)]
    for i in range(S0, toks.shape[1]):
        logits, caches = ref_lm.decode_step(
            rp, caches, jnp.asarray(toks[:, i:i + 1]), tt, rcfg)
        tt += 1
        out.append(np32(logits))
    return np.stack(out, 1)


def _port_serve(port, b, pcfg, toks, S0, cache_len):
    pb = dict(as_port(b), inputs=t(toks[:, :S0]))
    logits, caches, tt = lm.prefill(port, pb, pcfg, cache_len=cache_len)
    out = [logits]
    for i in range(S0, toks.shape[1]):
        logits, caches = lm.decode_step(port, caches, t(toks[:, i:i + 1]),
                                        tt, pcfg)
        tt += 1
        out.append(logits)
    return torch.stack(out, 1)


@pytest.mark.parametrize("arch", ARCHS + ("attn_local_moe",))
def test_prefill_decode_matches_reference_and_full_forward(arch):
    """fp32: 8 prompt tokens, then 4 teacher-forced decode steps, in the
    capacity form against the reference's prefill + decode to 1e-5 (each
    decode step routes its 2 tokens alone, C = 8); in the dense form
    against the port's own full forward to 5e-4 (test_models.py's
    invariant). The local stack's prompt is twice its window."""
    rcfg, rp, pcfg, port = _pick(arch)
    B, S, S0 = 2, 12, 8
    b = make_batch(pcfg, B, S, seed=5)
    want = _ref_serve(rp, b, rcfg, b["inputs"], S0, S)
    got = _port_serve(port, b, pcfg, b["inputs"], S0, S)
    assert_allclose(got.numpy(), want, **FP32)
    dense = pcfg.replace(moe_impl="dense")
    got = _port_serve(port, b, dense, b["inputs"], S0, S)
    full = lm.lm_logits(port, as_port(b), dense)
    err = float((got - full[:, S0 - 1:]).abs().max())
    assert err < 5e-4, err


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ce_chunks", [1, 2])
def test_lm_loss_and_gradients_match_reference(arch, ce_chunks):
    """``lm_loss`` (CE + 0.01 x load balance + 1e-4 x z-loss), unchunked and
    in 2 CE chunks: the loss and its metrics (``ce_loss``, the three aux
    values, ``loss``) against the reference's to 1e-5 relative, and every
    parameter's gradient against ``jax.grad`` of the reference's loss, to
    2e-5 of the leaf's largest gradient (the router's included; the
    capacity form at capacity factor 0.25, so dropped choices pass no
    gradient on either side)."""
    rcfg, rp, pcfg, port = both(arch, ce_chunks=ce_chunks,
                                moe_capacity_factor=0.25)
    b = make_batch(pcfg, 2, 16, seed=7)
    (want, wm), wgrad = jax.value_and_grad(
        lambda p: ref_lm.lm_loss(p, as_ref(b), rcfg), has_aux=True)(rp)
    params = trainable(port)
    got, gm = lm.lm_loss(params, as_port(b), pcfg)
    assert set(gm) == set(wm) == {"ce_loss", "loss", *moe.AUX_KEYS}
    for k in wm:
        assert_allclose(float(gm[k].detach()), float(wm[k]), **AUX,
                        err_msg=k)
    assert float(gm["moe_drop_frac"]) > 0.0
    got.backward()
    ggrad = bridge.ref_tree(params, leaf=lambda ts, stacked: (
        torch.stack([p.grad for p in ts]) if stacked else ts[0].grad)
        .numpy())
    flat_w = jax.tree_util.tree_flatten_with_path(wgrad)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(ggrad)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w = np32(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= 2e-5 * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_bitwise(arch):
    """reference -> port -> reference gives the same leaves bit for bit
    (the routers, the experts, llama4's shared expert, the qk-norm
    scales), ``module_from_ref`` rebuilds the same module, and
    ``ref_ndims`` gives each leaf its rank in the reference's stacked
    layout: the stacked qk-norm scales rank 2 and the router 3, so AdamW
    decays them as the reference does (ROADMAP Queue 3), while the
    final norm's (d,) scale stays rank 1."""
    _, pcfg = cfgs(arch)
    ref = ref_params(arch)
    port = bridge.lm_from_ref(ref, pcfg)
    back = bridge.ref_tree(port)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    again = bridge.module_from_ref(back, port)
    for (n, a), (_, b) in zip(port.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    ranks = bridge.ref_ndims(port)
    want = {jax.tree_util.keystr(p): a.ndim for p, a in flat_ref}
    key, idx = MOE_LAYER[arch]
    for leaf, rank in (("attn.q_norm", 2), ("attn.k_norm", 2),
                       ("moe.router", 3), ("moe.wi", 4)):
        assert ranks[f"layers.{idx}.{leaf}"] == rank
        head, tail = leaf.split(".")
        assert want[f"['segments'][0]['{key}']['{head}']['{tail}']"] == rank
    assert ranks["final_norm.scale"] == 1
    if arch == "llama4-maverick-400b-a17b":
        assert ranks["layers.1.moe.shared.wg"] == 3


# ---------------------------------------------------------------------------
# serving and training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_matches_generate(arch):
    """``serve_batch`` on the CPU, reduced (bf16 compute, capacity form):
    the prompts it draws from ``default_rng(seed + 1)``, decoded through
    ``lm.generate``, give its tokens; every logit is finite."""
    pcfg = get_reduced(arch)
    port = lm.init_lm(pcfg, seed=0, device="cpu")
    B, P, G = 2, 6, 5
    out = serve.serve_batch(pcfg, batch=B, prompt_len=P, gen=G,
                            device="cpu", params=port)
    rng = np.random.default_rng(1)
    b = {"inputs": t(rng.integers(1, pcfg.vocab_size, size=(B, P)))}
    want = lm.generate(port, b, pcfg, G)
    np.testing.assert_array_equal(out["tokens"].numpy(), want.numpy())
    assert out["logits_finite"] and out["cache_len"] == P + G


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_moe_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id> --reduced --device
    cpu`` (``main``)."""
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "4", "--gen", "3"])
    assert f"[serve] {arch} on cpu: prefill" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_each_moe_arch(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <id> --reduced --device
    cpu`` (``main``): ``check_trainable`` lets MoE through, the loss is
    finite, the checkpoint holds the MoE and qk-norm leaves under the
    reference's keys, and ``--restore`` resumes from it."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path)]
    train_mod.main(args + ["--steps", "2"])
    train_mod.main(args + ["--steps", "3", "--restore"])
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out
    losses = re.findall(r"\[train\] done\. loss (\S+) -> (\S+)", out)
    assert len(losses) == 2 and all(np.isfinite(float(v)) for pair in losses
                                    for v in pair)
    key = MOE_LAYER[arch][0]
    files = [f for f in tmp_path.rglob("*.npz")]
    assert files
    with np.load(files[0]) as z:
        names = set(z.files)
    for leaf in ("moe/router", "moe/wi", "attn/q_norm", "attn/k_norm"):
        assert any(n.endswith(f"segments/0/{key}/{leaf}") for n in names), \
            (leaf, sorted(names)[:8])
