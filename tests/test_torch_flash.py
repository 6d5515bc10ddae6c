"""The flash kernel's decode form on the CPU: the split-and-combine algebra
(``attention_split_ref``) against the port's and the reference's plain
attention, the mixed-dtype and strided inputs the decode form takes, how
``attn_decode`` hands it the ring cache, and the reduced recurrentgemma-2b
bf16 serving path against the JAX reference. The kernels themselves run on
the card: tests/test_torch_cuda.py.

Inputs come from numpy seeds. Tolerances: 2e-5 in fp32 (``test_kernels.py``'s
own for flash); 2e-2 for the bf16 serving path
(``test_torch_griffin.py``'s own)."""

import dataclasses

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402

ARCH = "recurrentgemma-2b"
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def bhsd(seed, B, H, KV, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, hd)).astype(np.float32),
            rng.normal(size=(B, KV, Sk, hd)).astype(np.float32),
            rng.normal(size=(B, KV, Sk, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# (a) split-and-combine is the same function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_split", [1, 3, 16])
@pytest.mark.parametrize("G", [10, 2, 1])
@pytest.mark.parametrize("form", ["decode", "causal", "window+softcap"])
def test_split_ref_matches_plain_and_reference(n_split, G, form):
    """Keys cut into 1, 3 or 16 ranges (13 keys: with 16 ranges the last
    three are empty) over 10, 2 or 1 query heads a KV head, for one query
    (the decode form) and for 9 causal queries with and without a window
    and softcap: the same output as the port's ``attention_ref`` and the
    reference's ``ref.attention_ref``."""
    Sq, kw = {"decode": (1, dict(causal=False)),
              "causal": (9, dict(causal=True)),
              "window+softcap": (9, dict(causal=True, window=4,
                                         softcap=5.0))}[form]
    q, k, v = bhsd(G * 10 + n_split, 2, G, 1, Sq, 13, 32)
    got = fa.attention_split_ref(t(q), t(k), t(v), n_split, **kw).numpy()
    assert_allclose(got, fa.attention_ref(t(q), t(k), t(v), **kw).numpy(),
                    **F32_TOL)
    want = np.asarray(ref_oracles.attention_ref(
        *map(jnp.asarray, (q, k, v)), **kw), np.float32)
    assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("n_split", [1, 5])
def test_split_ref_writes_zeros_for_rows_without_keys(n_split):
    """Rows past ``seq_q``, and a row whose ``seq_k`` is 0: exact zeros, as
    the kernels write them."""
    q, k, v = map(t, bhsd(3, 1, 2, 1, 4, 6, 16))
    got = fa.attention_split_ref(q, k, v, n_split, seq_q=2, seq_k=5)
    assert torch.equal(got[:, :, 2:], torch.zeros_like(got[:, :, 2:]))
    assert_allclose(got.numpy(), fa.attention_ref(
        q, k, v, seq_q=2, seq_k=5).numpy(), **F32_TOL)
    got = fa.attention_split_ref(q[:, :, :1], k, v, n_split, causal=False,
                                 seq_k=0)
    assert torch.equal(got, torch.zeros_like(got))


def test_decode_splits_fill_the_card():
    """recurrentgemma-2b's decode (8 rows x 1 KV head) on 132 SMs: 16
    ranges, 128 blocks; never fewer than 1 or more than 64."""
    assert fa.decode_splits(8, 132) == 16
    assert fa.decode_splits(1, 132) == fa.MAX_SPLITS == 64
    assert fa.decode_splits(500, 132) == 1


@pytest.mark.parametrize("B,H,KV,capacity,want", [
    (6, 8, 4, 89, 1),       # the dense sampler: 24 blocks over 89 slots
    (8, 10, 1, 2048, 16),   # recurrentgemma-2b's full 2048-key ring
    (8, 10, 1, 224, 1),     # 7 tiles: under 2 x MIN_SPLIT_TILES
    (8, 10, 1, 225, 2),
    (1, 1, 1, 8192, fa.MAX_SPLITS),
    (200, 8, 1, 2048, 1),   # the blocks fill the card alone
])
def test_decode_key_splits_follow_the_key_capacity(B, H, KV, capacity, want):
    """The decode form's automatic range count on 132 SMs: at most one
    range per ``MIN_SPLIT_TILES`` tiles of 32 of the views' length, so the
    dense sampler's 89-slot cache is one range (no combine launch) while
    recurrentgemma-2b's ring keeps 16; the live key count never enters."""
    blocks = B * KV * -(-(H // KV) // fa.DECODE_GROUP)
    got = fa.decode_key_splits(blocks, capacity, 132)
    assert got == want
    assert got <= fa.decode_splits(blocks, 132)
    assert "n_keys" not in inspect.signature(fa.decode_key_splits).parameters


def test_attn_decode_hands_the_whole_cache_with_its_live_length(
        monkeypatch):
    """The dense sampler's decode steps give the flash wrapper the cache's
    full length (the range count's capacity: backbone + BOS + the sampled
    length) with ``seq_k`` its filled slots, and attending over the whole
    cache with ``seq_k = n`` equals attending over its first n slots."""
    from repro_torch.models import protein as prot
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw.get("seq_k")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = get_reduced("progen-s").replace(compute_dtype="float32")
    params = prot.init_progen(cfg, 0, device="cpu")
    bb = torch.randn(1, cfg.frontend_seq, 16,
                     generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        prot.progen_sample(params, bb, 2, 5, cfg, seeds=[1])
    L = cfg.frontend_seq + 1 + 5
    steps = [(k, n) for s, k, n in seen if s == 1]
    assert len(steps) == 4 * cfg.n_layers       # length - 1 decode steps
    assert {k for k, _ in steps} == {L}
    # the prompt fills L - 5 slots; each step writes one more, and the
    # last sampled token is never written
    assert sorted({n for _, n in steps}) == list(range(L - 4, L))
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1, 4, 16, generator=g)
    cache = torch.randn(2, 12, 2, 16, generator=g)
    assert_allclose(real(q, cache, cache, causal=False, seq_k=5).numpy(),
                    real(q, cache[:, :5], cache[:, :5],
                         causal=False).numpy(), **F32_TOL)


# ---------------------------------------------------------------------------
# (b), (c) the inputs the decode form takes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 7])
def test_fp32_query_over_bf16_kv_is_the_upcast_call(S):
    """An fp32 q over bf16 K/V (model layout) gives bitwise the output of
    the same call on K/V widened to fp32 first: bf16 -> fp32 is exact."""
    rng = np.random.default_rng(S)
    q = t(rng.normal(size=(2, S, 10, 32)).astype(np.float32))
    k, v = (t(rng.normal(size=(2, 20, 1, 32)).astype(np.float32))
            .bfloat16() for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=S > 1, softcap=3.0)
    want = ops.flash_attention(q, k.float(), v.float(), causal=S > 1,
                               softcap=3.0)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_ring_view_is_the_contiguous_copy(dtype):
    """One query over the first n = 11 of L = 16 ring slots, handed over as
    the cache's own (B, n, KV, hd) view: the same output as over a
    contiguous copy of it."""
    rng = np.random.default_rng(9)
    cache = t(rng.normal(size=(3, 16, 2, 32)).astype(np.float32)).to(dtype)
    q = t(rng.normal(size=(3, 1, 4, 32)).astype(np.float32))
    view = cache[:, :11]
    assert not view.is_contiguous()
    got = ops.flash_attention(q, view, view, causal=False)
    want = ops.flash_attention(q, view.contiguous(), view.contiguous(),
                               causal=False)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (d) attn_decode reads the ring in place
# ---------------------------------------------------------------------------

def test_attn_decode_hands_the_kernel_the_cache_itself(monkeypatch):
    """Under bf16 compute recurrentgemma's query is fp32 and its ring cache
    bf16: ``attn_decode`` hands ``kops.flash_attention`` views of the
    cache's own storage, in bf16, the whole cache with ``seq_k`` its filled
    slots, and no copy."""
    cfg = get_reduced(ARCH).replace(compute_dtype="bfloat16")
    layer = lm.init_lm(cfg, seed=0, device="cpu").layers[2].attn
    seen = []
    real = attention.kops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v, kw["seq_k"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention.kops, "flash_attention", spy)
    cache = attention.init_cache(cfg, 2, 40, window=cfg.attn_window)
    x = t(np.random.default_rng(2).normal(
        size=(2, 1, cfg.d_model)).astype(np.float32))
    for pos in (0, 5):
        attention.attn_decode(layer, x, pos, cfg, cache=cache)
        q, k, v, seq_k = seen[-1]
        assert q.dtype == torch.float32
        assert seq_k == min(pos + 1, cache["k"].shape[1])
        for got, name in ((k, "k"), (v, "v")):
            assert got.dtype == cache[name].dtype == torch.bfloat16
            assert got.data_ptr() == cache[name].data_ptr()
            assert got.shape[1] == cache[name].shape[1]
            assert got.stride() == cache[name].stride()


# ---------------------------------------------------------------------------
# (e) the reduced bf16 serving path against the reference
# ---------------------------------------------------------------------------

_PARAMS = {}
_ref_prefill = jax.jit(ref_lm.prefill, static_argnums=(2, 3))
_ref_decode = jax.jit(ref_lm.decode_step, static_argnums=(4,))


def ref_params():
    if "p" not in _PARAMS:
        init = jax.jit(ref_lm.init_lm, static_argnums=(1,))
        _PARAMS["p"] = jax.tree.map(np.asarray, init(
            jax.random.PRNGKey(0), ref_get_reduced(ARCH)))
    return _PARAMS["p"]


@pytest.mark.parametrize("S0", [8, 16])
def test_bf16_decode_matches_reference(S0):
    """Reduced recurrentgemma-2b under bf16 compute (fp32 query, bf16 ring):
    prefill of S0 tokens (up to the window of 16, where the reference's
    ring is right), then 4 decode steps reading the ring in place; every
    step's logits within 2e-2 of the reference's prefill / decode_step."""
    rcfg = dataclasses.replace(ref_get_reduced(ARCH),
                               compute_dtype="bfloat16")
    pcfg = get_reduced(ARCH).replace(compute_dtype="bfloat16")
    port = bridge.lm_from_ref(ref_params(), pcfg)
    rp = jax.tree.map(jnp.asarray, ref_params())
    S = S0 + 5
    toks = np.random.default_rng(S0).integers(
        0, rcfg.vocab_size, size=(2, S)).astype(np.int32)
    logits, caches, pos = lm.prefill(port, {"inputs": t(toks[:, :S0])},
                                     pcfg, cache_len=S)
    r_logits, r_caches, r_pos = _ref_prefill(
        rp, {"inputs": jnp.asarray(toks[:, :S0])}, rcfg, S)
    assert caches[2]["k"].dtype == torch.bfloat16
    assert_allclose(logits.numpy(), np.asarray(r_logits, np.float32),
                    atol=2e-2, rtol=2e-2)
    for i in range(S0, S - 1):
        logits, caches = lm.decode_step(port, caches, t(toks[:, i:i + 1]),
                                        pos + i - S0, pcfg)
        r_logits, r_caches = _ref_decode(rp, r_caches,
                                         jnp.asarray(toks[:, i:i + 1]),
                                         r_pos + i - S0, rcfg)
        assert logits.dtype == torch.float32
        assert_allclose(logits.numpy(), np.asarray(r_logits, np.float32),
                        atol=2e-2, rtol=2e-2)
