"""The dense decoders and whisper's encoder-decoder, port vs the JAX
reference on the CPU: llama3-8b, smollm-360m, chatglm3-6b (interleaved
RoPE on half the head dim), nemotron-4-15b (squared-ReLU MLP, layernorm),
llava-next-34b (the patch prefix) and whisper-small (encoder, cross-
attention, the cross cache, the GELU MLP).

Both sides are built from the reference's own seeded ``init_lm`` through
``repro_torch.bridge``; inputs from numpy seeds; reduced configs. The
reference runs as its own tests run it (``attn_impl`` "xla", on the CPU).
Tolerances: 1e-5 in fp32 (``test_torch_models.py``'s: both sides in full
fp32), 2e-2 in bf16 through teacher-forced log-probs (that file's bf16
tolerance), 5e-4 for the port's prefill + decode against its own full
forward (``test_models.py``'s)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_reduced)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, common, lm, mlp  # noqa: E402
from repro_torch.models.common import trainable  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.optim import make_train_step  # noqa: E402

ARCHS = ("llama3-8b", "smollm-360m", "chatglm3-6b", "nemotron-4-15b",
         "llava-next-34b", "whisper-small")
FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
# test_models.py's parameter-count ranges; whisper-small has none there
RANGES = {"smollm-360m": (0.30e9, 0.50e9), "llama3-8b": (7.5e9, 8.6e9),
          "chatglm3-6b": (5.5e9, 7.0e9), "nemotron-4-15b": (14e9, 17e9),
          "llava-next-34b": (32e9, 37e9)}


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


def cfgs(arch, dtype="float32"):
    """(reference cfg, port cfg) of the reduced config at ``dtype``."""
    return (dataclasses.replace(ref_get_reduced(arch), compute_dtype=dtype),
            get_reduced(arch).replace(compute_dtype=dtype))


_PARAMS = {}


def ref_params(arch):
    """The reference's seeded reduced weights, numpy leaves (the compute
    dtype does not change them)."""
    if arch not in _PARAMS:
        init = jax.jit(ref_lm.init_lm, static_argnums=(1,))
        _PARAMS[arch] = jax.tree.map(np.asarray, init(
            jax.random.PRNGKey(0), ref_get_reduced(arch)))
    return _PARAMS[arch]


def both(arch, dtype="float32"):
    """(reference cfg, reference params as jax arrays, port cfg, port LM)."""
    rcfg, pcfg = cfgs(arch, dtype)
    return (rcfg, jax.tree.map(jnp.asarray, ref_params(arch)), pcfg,
            bridge.lm_from_ref(ref_params(arch), pcfg))


def make_batch(cfg, B, S, seed):
    """Numpy batch: tokens in [1, vocab), targets, and the frontend stub
    (0.02 x normal, as the reference's tests draw it)."""
    rng = np.random.default_rng(seed)
    b = {"inputs": rng.integers(1, cfg.vocab_size, size=(B, S))
         .astype(np.int32),
         "targets": rng.integers(1, cfg.vocab_size, size=(B, S))
         .astype(np.int32)}
    stub = 0.02 * rng.normal(size=(B, cfg.frontend_seq, cfg.d_model))
    if cfg.frontend == "vision_patches":
        b["patches"] = stub.astype(np.float32)
    elif cfg.frontend == "audio_frames":
        b["frames"] = stub.astype(np.float32)
    return b


def as_ref(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_port(b):
    return {k: t(v) for k, v in b.items()}


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
    assert len(port.encoder_kinds) == sum(
        len(k) * r for k, r in ref.encoder_segments)


def test_registry_holds_the_references_dense_ids_and_refuses_moe():
    """The registry holds all ten of the reference's ids, in its order, the
    two MoE ones included: each returns the reference's fields, full and
    reduced. The name dates from before the MoE configs were ported (the
    registry refused them) and is kept so the test's history stays one
    series; an unknown id still raises."""
    from repro.configs.registry import ARCH_IDS as REF_IDS
    assert ARCH_IDS == REF_IDS and len(ARCH_IDS) == 10
    for arch in ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"):
        for get, ref_get in ((get_config, ref_get_config),
                             (get_reduced, ref_get_reduced)):
            assert dataclasses.asdict(get(arch)) == \
                dataclasses.asdict(ref_get(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def _ref_shapes(tree, cfg):
    """Reference leaves by the port's parameter names, each segment split
    per layer (the leading ``repeats`` axis dropped), the encoder's into
    ``enc_layers``."""
    out = {}

    def walk(node, prefix, stacked):
        for name, sub in node.items():
            if isinstance(sub, dict):
                walk(sub, f"{prefix}{name}.", stacked)
            else:
                out[f"{prefix}{name}"] = tuple(sub.shape[1:] if stacked
                                               else sub.shape)

    tree = dict(tree)
    stacks = [(tree.pop("segments"), "layers", cfg.segments)]
    if "enc_segments" in tree:
        stacks.append((tree.pop("enc_segments"), "enc_layers",
                       cfg.encoder_segments))
    walk(tree, "", False)
    for segments, name, plan in stacks:
        idx = 0
        for seg, (kinds, reps) in zip(segments, plan):
            for _ in range(reps):
                for i, kind in enumerate(kinds):
                    walk(seg[f"{i}_{kind}"], f"{name}.{idx}.", True)
                    idx += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_structure_on_meta(arch):
    """The full-width model on the meta device: the reference's parameter
    names and shapes (``jax.eval_shape`` of its ``init_lm``), its leaf
    count, everything outside the norms equal to ``param_count`` and the
    total in test_models.py's range."""
    cfg = get_config(arch)
    with torch.device("meta"):
        model = lm.LM(cfg)
    ref = jax.eval_shape(lambda: ref_lm.init_lm(jax.random.PRNGKey(0),
                                                ref_get_config(arch)))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == _ref_shapes(ref, cfg)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    no_norm = sum(p.numel() for name, p in model.named_parameters()
                  if "norm" not in name)
    assert no_norm == cfg.param_count()
    if arch in RANGES:
        lo, hi = RANGES[arch]
        assert lo <= n <= hi, n
    if cfg.mlp_type in mlp.UNGATED:
        assert not hasattr(model.layers[0].mlp, "wg")


# ---------------------------------------------------------------------------
# the pieces: RoPE, the MLPs, the encoder, the cross cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["chatglm3-6b", "llama3-8b"])
def test_rope_per_row_positions(arch):
    """chatglm3's interleaved RoPE on half the head dim (llama3's half
    style beside it), at per-row (B, S) and shared (S,) positions, at its
    full head dim of 128 and the reduced one of 16."""
    rng = np.random.default_rng(1)
    for rcfg in (ref_get_config(arch), ref_get_reduced(arch)):
        pcfg = (get_config if rcfg.n_layers > 2 else get_reduced)(arch)
        x = rng.normal(size=(2, 5, 3, rcfg.head_dim)).astype(np.float32)
        pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
        for p in (pos, pos[0]):
            want = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(p), rcfg)
            got = common.apply_rope(t(x), t(p), pcfg)
            assert_allclose(got.numpy(), np32(want), **FP32)
        rot = int(rcfg.head_dim * rcfg.rope_fraction)
        assert_allclose(got[..., rot:].numpy(), x[..., rot:])  # untouched


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "whisper-small"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ungated_mlp_matches_reference(arch, dtype):
    """nemotron's squared ReLU and whisper's GELU (the reference's tanh
    form), no ``wg``."""
    rcfg, pcfg = cfgs(arch, dtype)
    seg = "0_dec_attn" if arch == "whisper-small" else "0_attn"
    p = ref_params(arch)["segments"][0][seg]["mlp"]
    assert set(p) == {"wi", "wo"}
    port = bridge.lm_from_ref(ref_params(arch), pcfg).layers[0].mlp
    x = np32(jnp.asarray(np.random.default_rng(2).normal(
        size=(2, 6, pcfg.d_model)), dtype))
    want = ref_mlp.mlp_fwd(jax.tree.map(lambda a: jnp.asarray(a[0]), p),
                           jnp.asarray(x, dtype), rcfg)
    got = mlp.mlp_fwd(port, t(x).to(common.torch_dtype(dtype)), pcfg)
    assert_allclose(got.float().numpy(), np32(want),
                    **(FP32 if dtype == "float32" else BF16))


def test_encode_cross_cache_and_cross_decode_match_reference():
    """whisper's ``_encode`` (RoPE over the frame positions, bidirectional
    attention), ``init_cross_cache`` of the first decoder layer's
    cross-attention over the encoder output, and one cross decode read."""
    rcfg, rp, pcfg, port = both("whisper-small")
    rng = np.random.default_rng(3)
    frames = (0.02 * rng.normal(size=(2, pcfg.frontend_seq, pcfg.d_model))
              ).astype(np.float32)
    want = ref_lm._encode(rp, jnp.asarray(frames), rcfg)
    enc = lm._encode(port, t(frames), pcfg)
    assert_allclose(enc.numpy(), np32(want), **FP32)

    rx = jax.tree.map(lambda a: a[0], rp["segments"][0]["0_dec_attn"]["xattn"])
    r_cache = ref_attn.init_cross_cache(rx, want, rcfg)
    p_cache = attention.init_cross_cache(port.layers[0].xattn, enc, pcfg)
    for name in ("k", "v"):
        assert_allclose(p_cache[name].numpy(), np32(r_cache[name]), **FP32)
    x = rng.normal(size=(2, 1, pcfg.d_model)).astype(np.float32)
    r_out, _ = ref_attn.attn_decode(rx, jnp.asarray(x), 5, rcfg,
                                    cache=r_cache, cross=True)
    p_out, same = attention.attn_decode(port.layers[0].xattn, t(x), 5, pcfg,
                                        cache=p_cache, cross=True)
    assert_allclose(p_out.numpy(), np32(r_out), **FP32)
    assert same is p_cache                      # read-only
    # the prompt's cross-attention builds the same cache
    xs = rng.normal(size=(2, 4, pcfg.d_model)).astype(np.float32)
    r_pre = ref_attn.attn_fwd(rx, jnp.asarray(xs), None, rcfg, causal=False,
                              kv_x=want, rope=False)
    p_pre, c2 = attention.cross_prefill(port.layers[0].xattn, t(xs), enc,
                                        pcfg)
    assert_allclose(p_pre.numpy(), np32(r_pre), **FP32)
    assert torch.equal(c2["k"], p_cache["k"])


# ---------------------------------------------------------------------------
# the flash kernel's algebra at the shapes these archs give it
# ---------------------------------------------------------------------------

FLASH_SHAPES = {  # (B, H, KV, Sq, Sk, hd), causal: the archs' shapes, cut
    "chatglm3 G=16 hd 128": ((1, 32, 2, 40, 40, 128), True),
    "llava G=7 hd 128": ((1, 14, 2, 37, 37, 128), True),
    "smollm G=3 hd 64": ((1, 15, 5, 33, 33, 64), True),
    "whisper encoder, keys not a tile multiple": ((1, 4, 4, 75, 75, 64),
                                                  False),
    "whisper cross, Sq != Sk": ((2, 4, 4, 9, 75, 64), False),
}


def _bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("case", list(FLASH_SHAPES))
def test_flash_sequence_algebra_at_the_archs_shapes(case):
    """The bf16 sequence form's algebra (``attention_tiled_ref``: 32-key
    tiles, ``live_key_tiles``, P rounded to bf16) against the plain version
    and the reference's masked softmax (``_sdpa_xla``, the function its
    prefill, encoder and cross-attention run), at GQA groups of 16, 7 and
    3, hd 128 and 64, keys past the last full tile and Sq != Sk, in bf16
    to 2e-2."""
    (B, H, KV, Sq, Sk, hd), causal = FLASH_SHAPES[case]
    rng = np.random.default_rng(Sq * Sk + H)
    q, k, v = _bf16(rng, B, H, Sq, hd), _bf16(rng, B, KV, Sk, hd), \
        _bf16(rng, B, KV, Sk, hd)
    got = fa.attention_tiled_ref(q, k, v, causal=causal).float().numpy()
    plain = fa.attention_ref(q, k, v, causal=causal).float().numpy()
    assert_allclose(got, plain, **BF16)
    rcfg = ref_get_reduced("llama3-8b")
    mask = None
    if causal:
        mask = ref_attn.make_mask(jnp.arange(Sq), jnp.arange(Sk), True, 0)
        mask = mask[None, None, None]
    bshd = [jnp.asarray(a.float().numpy().transpose(0, 2, 1, 3),
                        jnp.bfloat16) for a in (q, k, v)]
    want = np32(ref_attn._sdpa_xla(*bshd, mask, rcfg)).transpose(0, 2, 1, 3)
    assert_allclose(got, want, **BF16)


def test_flash_decode_algebra_over_a_cross_cache():
    """The decode form's split-and-combine algebra (``attention_split_ref``)
    at one query over 75 keys (not a tile multiple), a group of 16 heads at
    hd 128 and whisper's group of 1 at hd 64, in 1, 2 and 3 key ranges,
    against the plain version; and the sequence kernels' tile rule loads
    every tile of a 1500-frame non-causal pass."""
    rng = np.random.default_rng(9)
    for H, KV, hd in ((32, 2, 128), (4, 4, 64)):
        q, k, v = _bf16(rng, 2, H, 1, hd), _bf16(rng, 2, KV, 75, hd), \
            _bf16(rng, 2, KV, 75, hd)
        want = fa.attention_ref(q, k, v, causal=False).float().numpy()
        for n in (1, 2, 3):
            got = fa.attention_split_ref(q, k, v, n, causal=False)
            assert_allclose(got.float().numpy(), want, **BF16)
    assert list(fa.live_key_tiles(0, 63, 1500, 1500, False, 0, 32)) == \
        list(range(47))
    assert list(fa.live_key_tiles(0, 63, 64, 1500, False, 0, 32)) == \
        list(range(47))


# ---------------------------------------------------------------------------
# the model: forward, prefill + decode, a train step, the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_logits_matches_reference(arch):
    rcfg, rp, pcfg, port = both(arch)
    b = make_batch(pcfg, 2, 10, seed=4)
    want, _ = ref_lm.lm_logits(rp, as_ref(b), rcfg)
    got = lm.lm_logits(port, as_port(b), pcfg)
    assert got.shape == want.shape == (2, 10, pcfg.padded_vocab)
    assert_allclose(got.numpy(), np32(want), **FP32)


def _ref_serve(rp, b, rcfg, toks, S0, cache_len):
    """Reference prefill over the first S0 tokens, then teacher-forced
    decode steps over the rest: one logits row a position from S0 - 1."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_reference_and_full_forward(arch):
    """fp32: 8 prompt tokens, then 4 teacher-forced decode steps, against
    the reference's prefill + decode to 1e-5, and against the port's own
    full forward to test_models.py's 5e-4."""
    rcfg, rp, pcfg, port = both(arch)
    B, S, S0 = 2, 12, 8
    b = make_batch(pcfg, B, S, seed=5)
    cache_len = lm.prefix_len(b, pcfg) + S
    want = _ref_serve(rp, b, rcfg, b["inputs"], S0, cache_len)
    got = _port_serve(port, b, pcfg, b["inputs"], S0, cache_len)
    assert_allclose(got.numpy(), want, **FP32)
    full = lm.lm_logits(port, as_port(b), pcfg)
    err = float((got - full[:, S0 - 1:]).abs().max())
    assert err < 5e-4, err


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_decode_logprobs_match_reference(arch):
    """bf16 compute: the teacher-forced log-probs of the prefill + decode
    path, against the reference's, to 2e-2."""
    rcfg, rp, pcfg, port = both(arch, "bfloat16")
    B, S, S0 = 2, 10, 6
    b = make_batch(pcfg, B, S, seed=6)
    cache_len = lm.prefix_len(b, pcfg) + S
    want = _ref_serve(rp, b, rcfg, b["inputs"], S0, cache_len)
    got = _port_serve(port, b, pcfg, b["inputs"], S0, cache_len).float()
    V = pcfg.vocab_size
    want_lp = jax.nn.log_softmax(jnp.asarray(want[..., :V]), -1)
    got_lp = torch.log_softmax(got[..., :V], -1)
    nxt = b["inputs"][:, S0:]                    # the tokens fed next
    pick = lambda lp: np.take_along_axis(         # noqa: E731
        np32(lp)[:, :-1], nxt[..., None], -1)[..., 0]
    assert_allclose(pick(got_lp.numpy()), pick(want_lp), **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_loss(arch):
    """test_models.py's one train step: the fp32 loss equals the
    reference's ``lm_loss`` to 1e-5, it is finite, the step count is 1,
    weights moved and none is NaN."""
    rcfg, rp, pcfg, port = both(arch)
    b = make_batch(pcfg, 2, 16, seed=7)
    want, _ = ref_lm.lm_loss(rp, as_ref(b), rcfg)
    params = trainable(port)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = init_opt_state(dict(params.named_parameters()), opt)
    params, state, metrics = make_train_step(pcfg, opt)(params, state,
                                                        as_port(b))
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    assert loss == pytest.approx(float(want), rel=1e-5)
    assert int(state["count"]) == 1
    assert any(not torch.equal(p.detach(), before[n])
               for n, p in params.named_parameters())
    assert not any(bool(torch.isnan(p).any()) for p in params.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_bitwise(arch):
    """reference -> port -> reference gives the same leaves bit for bit,
    the encoder's stacked leaves and the MLP without ``wg`` included, and
    ``module_from_ref`` rebuilds the same module; ``ref_ndims`` counts the
    stacked axis of encoder layers too."""
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
    for name, p in port.named_parameters():
        stacked = name.startswith(("layers.", "enc_layers."))
        assert ranks[name] == p.dim() + stacked
    assert ("enc_segments" in back) == (arch == "whisper-small")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_serve_batch_takes_each_frontend(arch):
    """``serve_batch`` on the CPU with a frontend: the prompts and the stub
    it draws from ``default_rng(seed + 1)`` (0.02 x normal), decoded
    through ``lm.generate`` (whose caches hold the patch prefix too), give
    its tokens; every logit is finite; the self caches hold the patch
    prefix (llava's, not whisper's frames), the prompt and the tokens."""
    _, pcfg = cfgs(arch)
    port = lm.init_lm(pcfg, seed=0, device="cpu")
    B, P, G = 2, 6, 5
    out = serve.serve_batch(pcfg, batch=B, prompt_len=P, gen=G,
                            device="cpu", params=port)
    rng = np.random.default_rng(1)
    b = {"inputs": t(rng.integers(1, pcfg.vocab_size, size=(B, P)))}
    stub = 0.02 * rng.normal(size=(B, pcfg.frontend_seq, pcfg.d_model))
    b["patches" if arch == "llava-next-34b" else "frames"] = t(
        stub.astype(np.float32))
    want = lm.generate(port, b, pcfg, G)
    assert out["tokens"].shape == (B, G)
    np.testing.assert_array_equal(out["tokens"].numpy(), want.numpy())
    assert out["logits_finite"]
    prefix = pcfg.frontend_seq if arch == "llava-next-34b" else 0
    assert out["cache_len"] == prefix + P + G


@pytest.mark.parametrize("arch", (None,) + ARCHS)
def test_serve_cli_runs_each_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id> --reduced --device
    cpu`` (``main``) for each arch; without ``--arch`` it serves
    smollm-360m, the reference's default."""
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "4", "--gen", "3"]
    serve.main(args if arch is None else ["--arch", arch] + args)
    out = capsys.readouterr().out
    assert f"[serve] {arch or 'smollm-360m'} on cpu: prefill" in out


def test_reference_generate_drops_the_patch_prefix_where_the_port_does_not():
    """A reference fault (ROADMAP Queue 3): ``repro.models.lm.generate``
    sizes its default cache as prompt + steps, without llava's patch
    prefix, so from the second step on its decode writes past the cache
    (the update clamps to the last slot) and the tokens leave the greedy
    path of the full forward. The port's default cache holds the prefix:
    its tokens are the full forward's. Reduced llava-next-34b, fp32, 2
    rows x 6 tokens after 8 patches, 6 steps."""
    rcfg, rp, pcfg, port = both("llava-next-34b")
    B, S, steps = 2, 6, 6
    b = make_batch(pcfg, B, S, seed=10)
    rb = {k: v for k, v in as_ref(b).items() if k != "targets"}
    ref_toks = np.asarray(ref_lm.generate(rp, rb, rcfg, steps))
    got = lm.generate(port, {k: t(v) for k, v in b.items()
                             if k != "targets"}, pcfg, steps).numpy()
    seq = np.concatenate([b["inputs"], got[:, :-1]], 1)
    full = lm.lm_logits(port, dict(as_port(b), inputs=t(seq)), pcfg)
    greedy = full[:, S - 1:, :pcfg.vocab_size].argmax(-1).numpy()
    np.testing.assert_array_equal(got, greedy)
    assert (ref_toks[:, :1] == got[:, :1]).all()      # the prefill agrees
    assert (ref_toks != got).any()                    # the decode does not
