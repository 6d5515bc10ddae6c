"""The port's recurrentgemma slice against the JAX reference on the CPU: the
plain ``rglru`` (the CUDA kernel's CPU path), the Griffin recurrent block,
GeGLU, the local-attention ring cache, the reduced recurrentgemma-2b model
with its prefill + decode serving path, the reference's dtype flow under
bf16 compute, and the port's structure at full width (built on the
``meta`` device, no memory drawn).

Weights come from the reference's own ``init_lm`` through
``repro_torch.bridge``; inputs from numpy seeds. Tolerances are the
reference tests' own: rglru 1e-5 (``test_kernels.py``); layers 2e-5 in
fp32; model logits and prefill + decode 5e-4 in fp32 (``test_models.py``:
products over the whole model in other orders); 2e-2 in bf16."""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops, rglru  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, blocks, common, lm, ssm  # noqa: E402
from repro_torch.models.mlp import mlp_fwd  # noqa: E402

ARCH = "recurrentgemma-2b"
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
LM_TOL = dict(atol=5e-4, rtol=0)


def np32(x):
    return np.asarray(x, np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ---------------------------------------------------------------------------
# rglru: the plain version vs the Pallas kernel and the token-serial oracle
# ---------------------------------------------------------------------------

def rglru_inputs(seed, B, T, C):
    """a = sigmoid(N(0,1)), b = 0.3 N(0,1), a nonzero h0 (as the
    reference's kernel test draws them)."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, T, C))))).astype(np.float32)
    b = (0.3 * rng.normal(size=(B, T, C))).astype(np.float32)
    return a, b, rng.normal(size=(B, C)).astype(np.float32)


@pytest.mark.parametrize("B,T,C", [(1, 32, 8), (2, 96, 40), (2, 64, 128),
                                   (1, 50, 24), (3, 1, 40)])
def test_rglru_plain_matches_pallas_kernel_and_oracle(B, T, C):
    """The port's wrapper on CPU tensors against the reference's Pallas
    kernel in interpret mode (``test_kernels.py``'s shapes, and T=1, the
    decode step) and its token-serial oracle."""
    a, b, h0 = rglru_inputs(T + C, B, T, C)
    h, h_T = rglru.rglru_btc(t(a), t(b), t(h0))
    assert h.dtype == h_T.dtype == torch.float32
    assert h.shape == (B, T, C) and h_T.shape == (B, C)
    for h_ref, hT_ref in (ref_ops.rglru(*map(jnp.asarray, (a, b, h0)),
                                        interpret=True),
                          ref_oracles.rglru_ref(*map(jnp.asarray,
                                                     (a, b, h0)))):
        assert_allclose(h.numpy(), np32(h_ref), atol=1e-5, rtol=1e-5)
        assert_allclose(h_T.numpy(), np32(hT_ref), atol=1e-5, rtol=1e-5)
    got, got_T = ops.rglru(t(a), t(b), t(h0))
    assert torch.equal(got, h) and torch.equal(got_T, h_T)


def test_rglru_refuses_other_devices():
    """A device other than the CPU, CUDA and meta (the dry run's, which
    gives shapes) raises."""
    from test_torch_kernels import Elsewhere
    x = Elsewhere(1, 2, 4)
    with pytest.raises(ValueError):
        rglru.rglru_btc(x, x, Elsewhere(1, 4))
    m = torch.zeros(1, 2, 4, device="meta")
    h, h_T = rglru.rglru_btc(m, m, m[:, 0])
    assert h.is_meta and h.shape == m.shape and h_T.shape == (1, 4)


# ---------------------------------------------------------------------------
# configs and structure
# ---------------------------------------------------------------------------

KINDS = (("rglru", "rglru", "attn_local") * 8 + ("rglru", "rglru"))


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_reference(reduced):
    ref = (ref_get_reduced if reduced else ref_get_config)(ARCH)
    port = (get_reduced if reduced else get_config)(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    kinds = port.layer_kinds
    assert kinds == (KINDS[:3] + KINDS[-2:] if reduced else KINDS)


def _ref_shapes(tree, cfg):
    """Reference param leaves by the port's parameter names, segments split
    per layer (the leading ``repeats`` axis dropped)."""
    out = {}

    def walk(node, prefix, stacked):
        for name, sub in node.items():
            if isinstance(sub, dict):
                walk(sub, f"{prefix}{name}.", stacked)
            else:
                out[f"{prefix}{name}"] = tuple(sub.shape[1:] if stacked
                                               else sub.shape)

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


def test_full_width_lm_structure_on_meta():
    """recurrentgemma-2b at full width, built on the meta device: the
    reference's parameter names and shapes (``jax.eval_shape`` of its
    ``init_lm``), 2,894,574,080 parameters (``wr``/``wi`` included, which
    the reference's ``param_count`` leaves out), 18 ``rglru`` and 8
    ``attn_local`` layers in the reference's order."""
    cfg = get_config(ARCH)
    with torch.device("meta"):
        model = lm.LM(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ref = jax.eval_shape(lambda: ref_lm.init_lm(jax.random.PRNGKey(0),
                                                ref_get_config(ARCH)))
    assert shapes == _ref_shapes(ref, cfg)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert n == 2_894_574_080
    assert cfg.layer_kinds.count("rglru") == 18
    assert cfg.layer_kinds.count("attn_local") == 8
    assert all(hasattr(layer, "rec") == (kind == "rglru")
               for layer, kind in zip(model.layers, cfg.layer_kinds))
    assert not hasattr(model, "lm_head")                   # tied
    assert all(p.device.type == "meta" for p in model.parameters())


_PARAMS = {}


def ref_params():
    if "p" not in _PARAMS:
        init = jax.jit(ref_lm.init_lm, static_argnums=(1,))
        _PARAMS["p"] = jax.tree.map(np.asarray, init(
            jax.random.PRNGKey(0), ref_get_reduced(ARCH)))
    return _PARAMS["p"]


def cfgs(dtype="float32", **ref_kw):
    return (dataclasses.replace(ref_get_reduced(ARCH), compute_dtype=dtype,
                                **ref_kw),
            get_reduced(ARCH).replace(compute_dtype=dtype))


def port_lm(dtype="float32"):
    return bridge.lm_from_ref(ref_params(), cfgs(dtype)[1])


def test_lm_from_ref_fills_every_parameter():
    _, pcfg = cfgs()
    params = ref_params()
    port = bridge.lm_from_ref(params, pcfg)
    rec = params["segments"][1]["1_rglru"]["rec"]
    assert set(dict(port.layers[4].rec.named_parameters())) == set(rec)
    for name, leaf in rec.items():
        assert_allclose(getattr(port.layers[4].rec, name).numpy(), leaf[0])
    attn = params["segments"][0]["2_attn_local"]["attn"]
    assert_allclose(port.layers[2].attn.wq.numpy(), attn["wq"][0])
    assert_allclose(port.layers[2].mlp.wg.numpy(),
                    params["segments"][0]["2_attn_local"]["mlp"]["wg"][0])
    assert_allclose(port.embedding.tok.numpy(), params["embedding"]["tok"])
    seg = params["segments"][0]
    broken = dict(params, segments=[dict(seg, **{"0_rglru": dict(
        seg["0_rglru"], rec={k: a for k, a in seg["0_rglru"]["rec"].items()
                             if k != "wi"})}), params["segments"][1]])
    with pytest.raises(ValueError, match="wi"):
        bridge.lm_from_ref(broken, pcfg)


def test_seeded_init_lm_on_cpu():
    """init_lm draws every weight from its own seeded generator: the same
    seed gives the same model; ``lam`` is the logit of a in (0.9, 0.999)
    and the biases start at zero, as in the reference."""
    _, pcfg = cfgs()
    a, b = (lm.init_lm(pcfg, seed=3, device="cpu") for _ in range(2))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    rec = a.layers[0].rec
    decay = torch.sigmoid(rec.lam)
    assert bool((decay >= 0.9 - 1e-6).all() and (decay <= 0.999 + 1e-6).all())
    assert float(decay.std()) > 0.01
    assert not rec.br.any() and not rec.bi.any() and not rec.conv_b.any()
    C = pcfg.lru_width
    assert abs(float(rec.wr.std()) * np.sqrt(C) - 1.0) < 0.1


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rec_case(seed, T, layer=0):
    """Bridged weights of an rglru layer (port module, reference dict), an
    input sequence and a nonzero incoming state."""
    rcfg, pcfg = cfgs()
    port = port_lm().layers[layer].rec
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      ref_params()["segments"][0][f"{layer}_rglru"]["rec"])
    rng = np.random.default_rng(seed)
    B, d, C, W = 2, pcfg.d_model, pcfg.lru_width, pcfg.conv_width
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    state = {"h": rng.normal(size=(B, C)).astype(np.float32),
             "conv": rng.normal(size=(B, W - 1, C)).astype(np.float32)}
    return rcfg, pcfg, port, rp, x, state


@pytest.mark.parametrize("T", [1, 13])
def test_causal_conv1d_and_gates_match_reference(T):
    _, _, port, rp, x, st = _rec_case(50 + T, T)
    u = np.random.default_rng(T).normal(
        size=(2, T, port.conv_w.shape[1])).astype(np.float32)
    want, want_state = ref_ssm.causal_conv1d(
        jnp.asarray(u), rp["conv_w"], rp["conv_b"], jnp.asarray(st["conv"]))
    got, got_state = ssm.causal_conv1d(t(u), port.conv_w, port.conv_b,
                                       t(st["conv"]))
    assert_allclose(got.numpy(), np32(want), **LAYER_TOL)
    assert_allclose(got_state.numpy(), np32(want_state), atol=0, rtol=0)
    for g, w in zip(ssm._rglru_gates(port, t(u)),
                    ref_ssm._rglru_gates(rp, jnp.asarray(u))):
        assert g.dtype == torch.float32
        assert_allclose(g.numpy(), np32(w), **LAYER_TOL)


@pytest.mark.parametrize("T", [1, 13])
@pytest.mark.parametrize("ssm_impl", ["xla", "pallas_interpret"])
def test_rglru_block_matches_reference(T, ssm_impl):
    """From a nonzero state; T=1 is a decode step. The reference through
    its associative scan (``xla``) and its Pallas kernel."""
    rcfg, pcfg, port, rp, x, st = _rec_case(60 + T, T, layer=1)
    want_y, want_st = ref_ssm.rglru_block(
        rp, jnp.asarray(x), jax.tree.map(jnp.asarray, st),
        dataclasses.replace(rcfg, ssm_impl=ssm_impl))
    got_y, got_st = ssm.rglru_block(port, t(x), {k: t(a) for k, a in
                                                 st.items()}, pcfg)
    assert_allclose(got_y.numpy(), np32(want_y), **LAYER_TOL)
    assert set(got_st) == set(want_st) == {"h", "conv"}
    for name in want_st:
        assert got_st[name].dtype == torch.float32
        assert_allclose(got_st[name].numpy(), np32(want_st[name]),
                        **LAYER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_mlp_matches_reference(dtype):
    """GeGLU with the tanh-approximate GELU (``jax.nn.gelu``'s default), on
    an fp32 input: in bf16 compute both sides round the weights to bf16
    and multiply in fp32 (the reference's promotion)."""
    rcfg, pcfg = cfgs(dtype)
    port = bridge.lm_from_ref(ref_params(), pcfg).layers[0].mlp
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      ref_params()["segments"][0]["0_rglru"]["mlp"])
    x = np.random.default_rng(7).normal(
        size=(2, 5, pcfg.d_model)).astype(np.float32)
    want = ref_mlp.mlp_fwd(rp, jnp.asarray(x), rcfg)
    got = mlp_fwd(port, t(x), pcfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_allclose(got.numpy(), np32(want), **LAYER_TOL)


_ref_attn_prefill = jax.jit(ref_attn.attn_prefill, static_argnums=(3,),
                            static_argnames=("window",))
_ref_attn_decode = jax.jit(ref_attn.attn_decode, static_argnums=(3,),
                           static_argnames=("window",))


def _attn_case():
    rcfg, pcfg = cfgs()
    port = port_lm().layers[2].attn
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      ref_params()["segments"][0]["2_attn_local"]["attn"])
    return rcfg, pcfg, port, rp


@pytest.mark.parametrize("S,length", [(8, 24), (16, 24), (32, 40),
                                      (6, 10)])
def test_ring_cache_prefill_decode_match_reference(S, length):
    """``attn_prefill`` then 4 ``attn_decode`` steps of an ``attn_local``
    layer (window 16), where the reference's ring is right: a prompt no
    longer than the ring, or a multiple of it (the ring wraps during
    decode at S=16 and 32). ``length`` 10 gives a ring shorter than the
    window. Outputs and the cached K/V agree."""
    rcfg, pcfg, port, rp = _attn_case()
    W = pcfg.attn_window
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S + 4, pcfg.d_model)).astype(np.float32)
    cache = attention.init_cache(pcfg, 2, length, window=W)
    r_cache = ref_attn.init_cache(rcfg, 2, length, window=W)
    assert cache["k"].shape == r_cache["k"].shape
    out, cache = attention.attn_prefill(port, t(x[:, :S]), torch.arange(S),
                                        pcfg, cache=cache, window=W)
    want, r_cache = _ref_attn_prefill(rp, jnp.asarray(x[:, :S]),
                                      jnp.arange(S), rcfg, cache=r_cache,
                                      window=W)
    assert_allclose(out.numpy(), np32(want), **LAYER_TOL)
    for i in range(S, S + 4):
        out, cache = attention.attn_decode(port, t(x[:, i:i + 1]), i, pcfg,
                                           cache=cache)
        want, r_cache = _ref_attn_decode(rp, jnp.asarray(x[:, i:i + 1]), i,
                                         rcfg, cache=r_cache, window=W)
        assert_allclose(out.numpy(), np32(want), **LAYER_TOL)
    for name in ("k", "v"):
        assert_allclose(cache[name].numpy(), np32(r_cache[name]),
                        **LAYER_TOL)


def test_ring_prefill_puts_position_p_in_slot_p_mod_L():
    """A 21-token prompt into a 16-slot ring: positions 5..20 kept, each in
    slot p % 16 (the reference keeps them in slots 0..15)."""
    _, pcfg, port, _ = _attn_case()
    x = t(np.random.default_rng(1).normal(
        size=(1, 21, pcfg.d_model)).astype(np.float32))
    cache = attention.init_cache(pcfg, 1, 30, window=16)
    _, cache = attention.attn_prefill(port, x, torch.arange(21), pcfg,
                                      cache=cache, window=16)
    _, k, _ = attention._qkv(port, x, torch.arange(21), pcfg)
    for p in range(5, 21):
        assert torch.equal(cache["k"][:, p % 16], k[:, p])


def test_make_mask_is_the_references():
    q = np.arange(3, 9)
    k = np.array([-1, 0, 2, 4, 5, 7, 8, 11])
    for causal, window in ((True, 0), (True, 3), (False, 4), (False, 0)):
        want = np.asarray(ref_attn.make_mask(jnp.asarray(q), jnp.asarray(k),
                                             causal, window))
        got = attention.make_mask(t(q), t(k), causal, window).numpy()
        np.testing.assert_array_equal(got, want)


def test_dense_attn_decode_cache_kind_stays_unported():
    """Cache kinds: ``attn_local`` and ``rglru`` have decode caches, the
    dense ``attn`` kind IS ported now (the dense sampler's cache of
    ``length`` slots, not a ring), so is the ``attn_local_moe`` kind's ring,
    and a kind without a decode cache (the encoder's ``enc_attn``) raises.
    The name dates from before the dense kind was ported and is kept so
    the test's history stays one series."""
    cfg = get_reduced(ARCH)
    caches = lm.init_caches(cfg, 2, 40)
    assert caches[2]["k"].shape == (2, 16, 1, 32)
    assert caches[0]["conv"].shape == (2, 3, 64)
    assert blocks.init_layer_cache("attn", cfg, 2, 40)["k"].shape == \
        (2, 40, 1, 32)
    assert blocks.init_layer_cache("attn_local_moe", cfg, 2, 40)[
        "k"].shape == (2, 16, 1, 32)
    with pytest.raises(ValueError, match="not ported"):
        blocks.init_layer_cache("enc_attn", cfg, 2, 8)


# ---------------------------------------------------------------------------
# model and serving
# ---------------------------------------------------------------------------

def ref_logits(toks, dtype="float32", **kw):
    rcfg, _ = cfgs(dtype, **kw)
    return np32(ref_lm.lm_logits(jax.tree.map(jnp.asarray, ref_params()),
                                 {"inputs": jnp.asarray(toks)}, rcfg)[0])


def tokens(seed, B, S):
    return np.random.default_rng(seed).integers(
        0, ref_get_reduced(ARCH).vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("impl", [dict(), dict(ssm_impl="pallas_interpret",
                                               attn_impl="pallas_interpret")])
def test_lm_logits_matches_reference(impl):
    """24 tokens, past the window of 16, through the reference's XLA path
    and its Pallas kernels (interpret mode)."""
    toks = tokens(5, 2, 24)
    want = ref_logits(toks, **impl)
    got = lm.lm_logits(port_lm(), {"inputs": t(toks)}, cfgs()[1])
    assert got.shape == want.shape
    assert_allclose(got.numpy(), want, **LM_TOL)


def _serve(port, toks, S0, pcfg):
    """The port's prefill of S0 tokens, then decode steps over the rest:
    the logits of each step, and the caches."""
    S = toks.shape[1]
    logits, caches, pos = lm.prefill(port, {"inputs": t(toks[:, :S0])}, pcfg,
                                     cache_len=S)
    out = [logits.numpy()]
    for i in range(S0, S - 1):
        logits, caches = lm.decode_step(port, caches, t(toks[:, i:i + 1]),
                                        pos, pcfg)
        pos += 1
        out.append(logits.numpy())
    return out, caches


# the reference's serving functions, compiled once per config and shape
_ref_prefill = jax.jit(ref_lm.prefill, static_argnums=(2, 3))
_ref_decode = jax.jit(ref_lm.decode_step, static_argnums=(4,))


def _ref_serve(toks, S0, rcfg):
    S = toks.shape[1]
    rp = jax.tree.map(jnp.asarray, ref_params())
    logits, caches, pos = _ref_prefill(
        rp, {"inputs": jnp.asarray(toks[:, :S0])}, rcfg, S)
    out = [np32(logits)]
    for i in range(S0, S - 1):
        logits, caches = _ref_decode(
            rp, caches, jnp.asarray(toks[:, i:i + 1]), pos + i - S0, rcfg)
        out.append(np32(logits))
    return out, caches


@pytest.mark.parametrize("S0", [8, 16, 32])
def test_prefill_decode_matches_full_forward_and_reference(S0):
    """Serving invariant (``test_models.py``): prefill of S0 tokens, then 4
    decode steps, reproduce the full-sequence logits, and agree with the
    reference's prefill/decode_step step by step (S0 <= window or a
    multiple of it, where the reference's ring is right); the recurrent
    states and ring caches agree too."""
    rcfg, pcfg = cfgs()
    port = port_lm()
    toks = tokens(3, 2, S0 + 5)
    full = lm.lm_logits(port, {"inputs": t(toks)}, pcfg).numpy()
    got, caches = _serve(port, toks, S0, pcfg)
    want, r_caches = _ref_serve(toks, S0, rcfg)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_allclose(g, full[:, S0 - 1 + i], **LM_TOL)
        assert_allclose(g, w, **LM_TOL)
    layers = iter(caches)
    for seg, (kinds, reps) in zip(r_caches, rcfg.segments):
        for r in range(reps):
            for i, kind in enumerate(kinds):
                mine = next(layers)
                for name, arr in mine.items():
                    assert_allclose(arr.float().numpy(),
                                    np32(seg[f"{i}_{kind}"][name][r]),
                                    atol=1e-4, rtol=1e-3)


def test_reference_ring_cache_drifts_where_the_port_does_not():
    """A 20-token prompt into the reduced window of 16 (not a multiple of
    it): the port's prefill + 4 decode steps stay within 5e-4 of the full
    forward, while the reference's decode, which writes position t at slot
    t % 16 after its prefill kept positions 4..19 in slots 0..15,
    overwrites keys still inside the window and is more than 0.1 off."""
    rcfg, pcfg = cfgs()
    port = port_lm()
    toks = tokens(3, 2, 25)
    full = lm.lm_logits(port, {"inputs": t(toks)}, pcfg).numpy()
    got, _ = _serve(port, toks, 20, pcfg)
    want, _ = _ref_serve(toks, 20, rcfg)
    for i, g in enumerate(got):
        assert_allclose(g, full[:, 19 + i], **LM_TOL)
    assert_allclose(want[0], full[:, 19], **LM_TOL)      # prefill is right
    assert max(float(np.abs(w - full[:, 19 + i]).max())
               for i, w in enumerate(want)) > 0.1


def test_bf16_dtype_flow_matches_reference():
    """Under bf16 compute the reference's ``emb_scale`` (a numpy fp32
    scalar) promotes the embedding to fp32, and the residual stream and
    logits stay fp32; the port follows. Logits of the full forward and of
    prefill + 2 decode steps (K/V cached in bf16) agree to 2e-2."""
    rcfg, pcfg = cfgs("bfloat16")
    port = port_lm("bfloat16")
    toks = tokens(4, 2, 20)
    r_emb = ref_common.embed_tokens(
        jax.tree.map(jnp.asarray, ref_params()["embedding"]),
        jnp.asarray(toks), rcfg)
    emb = common.embed_tokens(port.embedding, t(toks), pcfg)
    assert r_emb.dtype == jnp.float32 and emb.dtype == torch.float32
    assert_allclose(emb.numpy(), np32(r_emb), atol=0, rtol=0)
    got = lm.lm_logits(port, {"inputs": t(toks)}, pcfg)
    assert got.dtype == torch.float32
    want = ref_logits(toks, "bfloat16")
    assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)
    got, caches = _serve(port, toks, 16, pcfg)
    assert caches[2]["k"].dtype == torch.bfloat16
    assert caches[0]["h"].dtype == torch.float32
    want, _ = _ref_serve(toks, 16, rcfg)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert_allclose(g, w, atol=2e-2, rtol=2e-2)


def test_greedy_generate_matches_reference_tokens():
    rcfg, pcfg = cfgs()
    prompts = tokens(8, 3, 10)
    with mock.patch.object(ref_lm, "prefill", _ref_prefill), \
            mock.patch.object(ref_lm, "decode_step", _ref_decode):
        want = ref_lm.generate(jax.tree.map(jnp.asarray, ref_params()),
                               {"inputs": jnp.asarray(prompts)}, rcfg, 6,
                               temperature=0.0)
    got = lm.generate(port_lm(), {"inputs": t(prompts)}, pcfg, 6)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_is_generate_with_timings(capsys):
    """serve_batch on the CPU: the prompts it draws (past the reduced
    window), decoded through prefill + decode_step, give the tokens
    ``lm.generate`` gives; the CLI runs the reduced model."""
    _, pcfg = cfgs()
    port = lm.init_lm(pcfg, seed=0, device="cpu")
    out = serve.serve_batch(pcfg, batch=2, prompt_len=20, gen=5,
                            device="cpu", params=port)
    prompts = np.random.default_rng(1).integers(1, pcfg.vocab_size,
                                                size=(2, 20))
    want = lm.generate(port, {"inputs": t(prompts)}, pcfg, 5)
    np.testing.assert_array_equal(out["tokens"].numpy(), want.numpy())
    assert out["logits_finite"] and out["prefill_s"] > 0
    assert out["decode_tok_s"] == pytest.approx(2 * 4 / out["decode_s"])
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "18", "--gen", "3"])
    assert f"[serve] {ARCH} on cpu" in capsys.readouterr().out


def test_entry_points_default_to_cuda():
    """Without a card, init_lm and serve_batch raise rather than fall back
    (the default device is cuda)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve_batch(cfg, batch=1, prompt_len=2, gen=2)
