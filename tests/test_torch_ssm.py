"""The port's RWKV-6 slice against the JAX reference on the CPU: the plain
``wkv6`` (the CUDA kernel's CPU path), the time/channel-mix layers, the
reduced rwkv6-7b model, its prefill + decode serving path and the port's
structure at full width (built on the ``meta`` device, no memory drawn).

Weights come from the reference's own ``init_lm`` through
``repro_torch.bridge``; inputs from numpy seeds. Tolerances are the
reference tests' own: wkv6 y 2e-5 (fp32) / 2e-2 (bf16) and state atol 1e-4
/ rtol 1e-3 (``test_kernels.py``); layers 2e-5 in fp32; model logits and
prefill + decode 5e-4 in fp32 (``test_models.py``: products over the whole
model in other orders and chunkings)."""

import contextlib
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
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops, rwkv6  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks, lm, ssm  # noqa: E402

ARCH = "rwkv6-7b"
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


STATE_TOL = dict(atol=1e-4, rtol=1e-3)


def np32(x):
    return np.asarray(x, np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ---------------------------------------------------------------------------
# wkv6: the plain version vs the Pallas kernel and the token-serial oracle
# ---------------------------------------------------------------------------

def wkv_inputs(seed, B, H, T, K, dtype):
    """r/k/v rounded to ``dtype`` once, so both sides see the same values;
    logw fp32 in (-inf, 0); a random bonus u and a nonzero state s0."""
    rng = np.random.default_rng(seed)
    rkv = [np32(jnp.asarray(0.5 * rng.normal(size=(B, H, T, K)), dtype))
           for _ in range(3)]
    logw = -np.exp(rng.normal(size=(B, H, T, K))).astype(np.float32)
    u = (0.3 + 0.1 * rng.normal(size=(H, K))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, K, K))).astype(np.float32)
    return (*rkv, logw, u, s0)


@pytest.mark.parametrize("B,H,T,K,chunk", [
    (1, 1, 32, 8, 8), (2, 3, 64, 16, 16), (1, 2, 48, 32, 16),
    (2, 2, 33, 16, 16), (2, 2, 31, 16, 16), (2, 3, 1, 16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_plain_matches_pallas_kernel_and_oracle(B, H, T, K, chunk,
                                                     dtype):
    """The port's wrapper on CPU tensors (the chunked plain version, a short
    last chunk where 32 does not divide T) against the reference's Pallas
    kernel in interpret mode (which shrinks its chunk to a divisor of T: 1
    for the prime T=31) and its token-serial oracle."""
    r, k, v, logw, u, s0 = wkv_inputs(T, B, H, T, K, dtype)
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(a, jdt) for a in (r, k, v)] + \
        [jnp.asarray(a) for a in (logw, u, s0)]
    y_pl, s_pl = ref_ops.wkv6(*jargs, chunk=chunk, interpret=True)
    y_or, s_or = ref_oracles.wkv6_ref(*jargs)
    targs = [t(a).to(TORCH_DT[dtype]) for a in (r, k, v)] + \
        [t(a) for a in (logw, u, s0)]
    y, s = rwkv6.wkv6_bhtk(*targs)
    assert y.dtype == TORCH_DT[dtype] and s.dtype == torch.float32
    assert y.shape == (B, H, T, K) and s.shape == (B, H, K, K)
    for y_ref, s_ref in ((y_pl, s_pl), (y_or, s_or)):
        assert_allclose(y.float().numpy(), np32(y_ref), **tol(dtype))
        assert_allclose(s.numpy(), np32(s_ref), **STATE_TOL)


@pytest.mark.parametrize("chunk", [1, 7, 32, 64])
def test_wkv6_plain_any_chunk_matches_oracle(chunk):
    """The chunk length is the plain version's own choice: every chunk,
    dividing T or not, gives the oracle's answer."""
    r, k, v, logw, u, s0 = wkv_inputs(9, 2, 2, 45, 16, "float32")
    y_or, s_or = ref_oracles.wkv6_ref(*map(jnp.asarray,
                                           (r, k, v, logw, u, s0)))
    y, s = rwkv6.wkv6_ref(*map(t, (r, k, v, logw, u, s0)), chunk=chunk)
    assert_allclose(y.numpy(), np32(y_or), **tol("float32"))
    assert_allclose(s.numpy(), np32(s_or), **STATE_TOL)


def test_wkv6_logw_at_both_ends_of_its_range():
    """logw at -e^5 (a decay that wipes the state in one token) and at
    -1e-6 (no decay), the two ends ``rwkv_streams`` clips to."""
    r, k, v, logw, u, s0 = wkv_inputs(4, 2, 2, 40, 16, "float32")
    logw[..., ::2] = -np.exp(5.0)
    logw[..., 1::2] = -1e-6
    y_or, s_or = ref_oracles.wkv6_ref(*map(jnp.asarray,
                                           (r, k, v, logw, u, s0)))
    y, s = ops.wkv6(*map(t, (r, k, v, logw, u, s0)))
    assert_allclose(y.numpy(), np32(y_or), **tol("float32"))
    assert_allclose(s.numpy(), np32(s_or), **STATE_TOL)


# ---------------------------------------------------------------------------
# configs and structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False])
def test_rwkv_config_matches_reference(reduced):
    ref = (ref_get_reduced if reduced else ref_get_config)(ARCH)
    port = (get_reduced if reduced else get_config)(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.layer_kinds == ("rwkv",) * ref.n_layers


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
    """rwkv6-7b at full width, built on the meta device: the reference's
    parameter names and shapes (from ``jax.eval_shape`` of its
    ``init_lm``) and a parameter count in ``test_models.py``'s range."""
    cfg = get_config(ARCH)
    with torch.device("meta"):
        model = lm.LM(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ref = jax.eval_shape(lambda: ref_lm.init_lm(jax.random.PRNGKey(0),
                                                ref_get_config(ARCH)))
    assert shapes == _ref_shapes(ref, cfg)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert 6.5e9 <= n <= 8.4e9, n
    assert all(p.device.type == "meta" for p in model.parameters())


_PARAMS = {}


def ref_params():
    if "p" not in _PARAMS:
        _PARAMS["p"] = jax.tree.map(np.asarray, ref_lm.init_lm(
            jax.random.PRNGKey(0), ref_get_reduced(ARCH)))
    return _PARAMS["p"]


def cfgs(dtype="float32", **ref_kw):
    return (dataclasses.replace(ref_get_reduced(ARCH), compute_dtype=dtype,
                                **ref_kw),
            get_reduced(ARCH).replace(compute_dtype=dtype))


def test_lm_from_ref_fills_every_parameter():
    _, pcfg = cfgs()
    params = ref_params()
    port = bridge.lm_from_ref(params, pcfg)
    tm = params["segments"][0]["0_rwkv"]["tm"]
    assert set(dict(port.layers[1].tm.named_parameters())) == set(tm)
    for name, leaf in tm.items():
        assert_allclose(getattr(port.layers[1].tm, name).numpy(), leaf[1])
    assert_allclose(port.lm_head.w.numpy(), params["lm_head"]["w"])
    broken = dict(params, segments=[{"0_rwkv": dict(
        params["segments"][0]["0_rwkv"],
        tm={k: a for k, a in tm.items() if k != "w0"})}])
    with pytest.raises(ValueError, match="w0"):
        bridge.lm_from_ref(broken, pcfg)


def test_seeded_init_lm_on_cpu():
    """init_lm draws every weight from its own seeded generator: the same
    seed gives the same model, the deterministic leaves are the
    reference's (w0, u, the token-shift mixes), LoRAs are scaled by 0.1."""
    _, pcfg = cfgs()
    a, b = (lm.init_lm(pcfg, seed=3, device="cpu") for _ in range(2))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    tm = a.layers[0].tm
    ref_tm = ref_params()["segments"][0]["0_rwkv"]["tm"]
    for name in ("w0", "u", "mu_x", "mu_r", "mu_ck", "gn_scale", "gn_bias"):
        assert_allclose(getattr(tm, name).numpy(), ref_tm[name][0],
                        atol=1e-6, rtol=1e-6)
    d = pcfg.d_model
    assert abs(float(tm.wr.std()) * np.sqrt(d) - 1.0) < 0.1
    assert abs(float(tm.aw.std()) * np.sqrt(d) - 0.1) < 0.02


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_case(seed, T):
    """Bridged layer-0 weights (port module, reference dict), an input
    sequence and a nonzero incoming state."""
    rcfg, pcfg = cfgs()
    port = bridge.lm_from_ref(ref_params(), pcfg).layers[0].tm
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      ref_params()["segments"][0]["0_rwkv"]["tm"])
    rng = np.random.default_rng(seed)
    B, d, K = 2, pcfg.d_model, pcfg.rwkv_head_dim
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    state = {"S": (0.3 * rng.normal(size=(B, d // K, K, K))).astype(
                 np.float32),
             "shift_tm": rng.normal(size=(B, d)).astype(np.float32),
             "shift_cm": rng.normal(size=(B, d)).astype(np.float32)}
    return rcfg, pcfg, port, rp, x, state


def _cmp_state(got, want, **kw):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.float32
        assert_allclose(got[name].numpy(), np32(want[name]), **kw)


@pytest.mark.parametrize("T", [1, 13])
def test_rwkv_streams_match_reference(T):
    rcfg, pcfg, port, rp, x, st = _layer_case(20 + T, T)
    want = ref_ssm.rwkv_streams(rp, jnp.asarray(x),
                                jnp.asarray(st["shift_tm"]), rcfg)
    got = ssm.rwkv_streams(port, t(x), t(st["shift_tm"]), pcfg)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np32(w), atol=2e-5, rtol=2e-5)
    logw = got[-1]
    assert logw.dtype == torch.float32 and float(logw.max()) <= -1e-6


@contextlib.contextmanager
def reference_scan(ssm_impl):
    """The reference's ``ssm_impl``, or ``"oracle"``: its XLA path with the
    chunked scan ``ssm.wkv6_chunked`` swapped, for the test, for its own
    token-serial oracle ``ref.wkv6_ref``."""
    if ssm_impl != "oracle":
        yield ssm_impl
        return
    with mock.patch.object(ref_ssm, "wkv6_chunked",
                           lambda r, k, v, w, u, s0, chunk=0:
                           ref_oracles.wkv6_ref(r, k, v, w, u, s0)):
        yield "xla"


@pytest.mark.parametrize("T,ssm_impl", [
    (1, "xla"), (1, "pallas_interpret"), (13, "xla"),
    (13, "pallas_interpret"), (70, "oracle")])
def test_rwkv_timemix_matches_reference(T, ssm_impl):
    """From a nonzero state; T=1 is a decode step. T=70 crosses the
    reference's 64-token chunk and the port's 32-token one; it is held
    against the reference with its token-serial scan, since the
    reference's chunked scans drift there (see
    ``test_reference_chunked_scan_drifts_where_the_port_does_not``)."""
    rcfg, pcfg, port, rp, x, st = _layer_case(30 + T, T)
    with reference_scan(ssm_impl) as impl:
        want_y, want_st = ref_ssm.rwkv_timemix(
            rp, jnp.asarray(x), jax.tree.map(jnp.asarray, st),
            dataclasses.replace(rcfg, ssm_impl=impl))
    got_y, got_st = ssm.rwkv_timemix(port, t(x), {k: t(a) for k, a in
                                                  st.items()}, pcfg)
    assert_allclose(got_y.numpy(), np32(want_y), atol=2e-5, rtol=2e-5)
    _cmp_state(got_st, want_st, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("T", [1, 13])
def test_rwkv_channelmix_matches_reference(T):
    rcfg, pcfg, port, rp, x, st = _layer_case(40 + T, T)
    want_y, want_st = ref_ssm.rwkv_channelmix(
        rp, jnp.asarray(x), jax.tree.map(jnp.asarray, st), rcfg)
    got_y, got_st = ssm.rwkv_channelmix(port, t(x), {k: t(a) for k, a in
                                                     st.items()}, pcfg)
    assert_allclose(got_y.numpy(), np32(want_y), atol=2e-5, rtol=2e-5)
    _cmp_state(got_st, want_st, atol=0, rtol=0)


def test_dense_attn_cache_is_not_ported():
    """progen-s's ``attn`` layers' dense K/V cache IS ported now (the
    dense sampler's), so is whisper's ``dec_attn`` cache (its self cache;
    prefill adds the cross cache it builds), so is a ``moe`` layer's
    dense K/V cache, and a kind without a decode cache (the encoder's
    ``enc_attn``) raises. The name dates from before the dense kind was
    ported and is kept so the test's history stays one series."""
    caches = lm.init_caches(get_reduced("progen-s"), 2, 8)
    assert [c["k"].shape for c in caches] == [(2, 8, 2, 16)] * 2
    assert blocks.init_layer_cache("rwkv", get_reduced(ARCH), 2, 8)[
        "S"].shape == (2, 4, 16, 16)
    dec = blocks.init_layer_cache("dec_attn", get_reduced(ARCH), 2, 8)
    assert dec["k"].shape == (2, 8, 4, 16)
    assert blocks.init_layer_cache("moe", get_reduced(ARCH), 2, 8)[
        "k"].shape == (2, 8, 4, 16)
    with pytest.raises(ValueError, match="not ported"):
        blocks.init_layer_cache("enc_attn", get_reduced(ARCH), 2, 8)


# ---------------------------------------------------------------------------
# model and serving
# ---------------------------------------------------------------------------

def ref_logits(toks, ssm_impl):
    rcfg, _ = cfgs()
    with reference_scan(ssm_impl) as impl:
        return np32(ref_lm.lm_logits(
            jax.tree.map(jnp.asarray, ref_params()),
            {"inputs": jnp.asarray(toks)},
            dataclasses.replace(rcfg, ssm_impl=impl))[0])


@pytest.mark.parametrize("ssm_impl", ["xla", "pallas_interpret", "oracle"])
def test_lm_logits_matches_reference(ssm_impl):
    """12 tokens (``test_models.py``'s serving length) through both
    reference paths, and through its token-serial scan."""
    _, pcfg = cfgs()
    port = bridge.lm_from_ref(ref_params(), pcfg)
    toks = np.random.default_rng(5).integers(
        0, pcfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = ref_logits(toks, ssm_impl)
    got = lm.lm_logits(port, {"inputs": t(toks)}, pcfg)
    assert got.shape == want.shape
    assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def test_reference_chunked_scan_drifts_where_the_port_does_not():
    """Over 64 tokens the port stays within 5e-4 of the reference run with
    its token-serial scan, while the reference's chunked scans (XLA and
    Pallas) drift past 1e-3 from it: they take each pairwise decay exponent
    as a difference of prefix sums of logw, which reach ~-4700 in a chunk
    where logw sits at its floor -e^5 (``w0`` clips there for the top
    channels), and fp32 differences of such sums are off by ~5e-4."""
    _, pcfg = cfgs()
    port = bridge.lm_from_ref(ref_params(), pcfg)
    toks = np.random.default_rng(5).integers(
        0, pcfg.vocab_size, size=(2, 64)).astype(np.int32)
    oracle = ref_logits(toks, "oracle")
    got = lm.lm_logits(port, {"inputs": t(toks)}, pcfg).numpy()
    assert_allclose(got, oracle, atol=5e-4, rtol=0)
    for impl in ("xla", "pallas_interpret"):
        assert np.abs(ref_logits(toks, impl) - oracle).max() > 1e-3


def test_prefill_decode_matches_full_forward_and_reference():
    """Serving invariant (``test_models.py``): prefill of 8 tokens, then 4
    decode steps, reproduce the full-sequence logits; each step's logits
    and the states also agree with the reference's prefill/decode_step."""
    rcfg, pcfg = cfgs()
    rp = jax.tree.map(jnp.asarray, ref_params())
    port = bridge.lm_from_ref(ref_params(), pcfg)
    B, S, S0 = 2, 12, 8
    toks = np.random.default_rng(3).integers(
        0, pcfg.vocab_size, size=(B, S)).astype(np.int32)
    full = lm.lm_logits(port, {"inputs": t(toks)}, pcfg).numpy()
    logits, caches, pos = lm.prefill(port, {"inputs": t(toks[:, :S0])}, pcfg,
                                     cache_len=S)
    r_logits, r_caches, r_pos = ref_lm.prefill(
        rp, {"inputs": jnp.asarray(toks[:, :S0])}, rcfg, cache_len=S)
    assert pos == r_pos == S0
    errs = [float(np.abs(logits.numpy() - full[:, S0 - 1]).max())]
    assert_allclose(logits.numpy(), np32(r_logits), atol=5e-4, rtol=0)
    for i in range(S0, S):
        logits, caches = lm.decode_step(port, caches, t(toks[:, i:i + 1]),
                                        pos, pcfg)
        r_logits, r_caches = ref_lm.decode_step(
            rp, r_caches, jnp.asarray(toks[:, i:i + 1]), r_pos, rcfg)
        pos += 1
        r_pos += 1
        errs.append(float(np.abs(logits.numpy() - full[:, i]).max()))
        assert_allclose(logits.numpy(), np32(r_logits), atol=5e-4, rtol=0)
    assert max(errs) < 5e-4, errs
    r_state = r_caches[0]["0_rwkv"]
    for layer in range(pcfg.n_layers):
        _cmp_state(caches[layer], jax.tree.map(lambda a: a[layer], r_state),
                   atol=1e-4, rtol=1e-3)


def test_greedy_generate_matches_reference_tokens():
    rcfg, pcfg = cfgs()
    port = bridge.lm_from_ref(ref_params(), pcfg)
    prompts = np.random.default_rng(8).integers(
        1, pcfg.vocab_size, size=(3, 10)).astype(np.int32)
    want = ref_lm.generate(jax.tree.map(jnp.asarray, ref_params()),
                           {"inputs": jnp.asarray(prompts)}, rcfg, 6,
                           temperature=0.0)
    got = lm.generate(port, {"inputs": t(prompts)}, pcfg, 6)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_is_generate_with_timings(capsys):
    """serve_batch on the CPU: the prompts it draws, decoded through
    prefill + decode_step, give the tokens ``lm.generate`` gives; the CLI
    runs the reduced model."""
    _, pcfg = cfgs()
    port = lm.init_lm(pcfg, seed=0, device="cpu")
    out = serve.serve_batch(pcfg, batch=2, prompt_len=7, gen=5,
                            device="cpu", params=port)
    prompts = np.random.default_rng(1).integers(1, pcfg.vocab_size,
                                                size=(2, 7))
    want = lm.generate(port, {"inputs": t(prompts)}, pcfg, 5)
    np.testing.assert_array_equal(out["tokens"].numpy(), want.numpy())
    assert out["logits_finite"] and out["prefill_s"] > 0
    assert out["decode_tok_s"] == pytest.approx(2 * 4 / out["decode_s"])
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2",
                "--prompt-len", "4", "--gen", "3"])
    assert "[serve] rwkv6-7b on cpu" in capsys.readouterr().out


def test_temperature_sampling_is_seeded():
    """With temperature > 0, serve_batch draws its Gumbel noise from a
    generator seeded ``seed + 2``: the tokens ``lm.generate`` gives with
    that generator."""
    _, pcfg = cfgs()
    port = lm.init_lm(pcfg, seed=0, device="cpu")
    out = serve.serve_batch(pcfg, batch=2, prompt_len=6, gen=5,
                            temperature=0.8, seed=0, device="cpu",
                            params=port)
    prompts = np.random.default_rng(1).integers(1, pcfg.vocab_size,
                                                size=(2, 6))
    want = lm.generate(port, {"inputs": t(prompts)}, pcfg, 5,
                       temperature=0.8,
                       gen=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(out["tokens"].numpy(), want.numpy())
    greedy = lm.generate(port, {"inputs": t(prompts)}, pcfg, 5)
    assert not torch.equal(want, greedy)


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
