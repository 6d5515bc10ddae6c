"""Flash attention with a query offset (``q_offset``: the global position of
query row 0, a context-parallel rank's chunk of the sequence) on the CPU.

The port's plain versions at an offset (``attention_ref``,
``attention_tiled_ref`` and ``flash_attention_grad``'s forward and
gradients) against the reference's XLA attention at global positions: its
masked softmax ``_sdpa_xla`` with ``make_mask(arange(off, off + Sq),
arange(Sk), causal, window)``, and its flash scan ``_flash_xla`` (key blocks
of 8) with its custom VJP through ``jax.vjp``. Causal, a window that
reaches past the offset, softcap and GQA; a one-query chunk; a chunk with
no live key. Beside them: each chunk's rows against the whole call's, the
tile-skipping rule (``live_key_tiles``) never skips a live pair at an
offset, ``cost.live_pairs`` / ``live_keys`` against a brute-force count of
the mask, and the decode form's key range (``decode_keys``). The kernels
run on the card: tests/test_torch_cuda.py.

Inputs come from numpy seeds. Tolerances: 2e-5 in fp32, 2e-2 in bf16
(``test_kernels.py``'s own for flash).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.models.attention import _flash_xla, _sdpa_xla, make_mask  # noqa
from repro_torch.distributed import cost  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

# label -> (B, H, KV, Sq, Sk, hd, q_offset, kwargs)
CASES = {
    "causal chunk 0 of 4": (2, 4, 2, 16, 64, 16, 0, dict(causal=True)),
    "causal chunk 3 of 4": (2, 4, 2, 16, 64, 16, 48, dict(causal=True)),
    "causal chunk 1 of 4, GQA 6/2": (1, 6, 2, 16, 64, 32, 16,
                                     dict(causal=True)),
    "window past the offset": (1, 4, 1, 20, 80, 32, 60,
                               dict(causal=True, window=24)),
    "window inside the chunk": (1, 2, 1, 24, 96, 16, 48,
                                dict(causal=True, window=5)),
    "softcap": (2, 4, 4, 16, 64, 16, 32, dict(causal=True, softcap=5.0)),
    "one-query chunk": (2, 4, 2, 1, 8, 16, 5, dict(causal=True)),
    "one-query chunk, window": (1, 3, 1, 1, 40, 32, 30,
                                dict(causal=True, window=7)),
    "non-causal": (1, 4, 2, 8, 32, 16, 24, dict(causal=False)),
}
# a chunk whose rows have no live key: non-causal, its window ends before
# the first key... and past the last one (the positions lie beyond Sk)
EMPTY = (1, 2, 1, 8, 16, 16, 40, dict(causal=False, window=4))


def inputs(seed, B, H, KV, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


def ref_cfg(softcap):
    return ModelConfig(name="t", family="dense", n_layers=1, d_model=8,
                       n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8,
                       attn_logit_softcap=softcap)


def sdpa_at(q, k, v, off, causal=True, window=0, softcap=0.0):
    """The reference's ``_sdpa_xla`` at global positions, in the port's
    (B,H,S,hd) layout."""
    Sq, Sk = q.shape[2], k.shape[2]
    mask = make_mask(jnp.arange(off, off + Sq), jnp.arange(Sk), causal,
                     window)[None, None, None]
    o = _sdpa_xla(*(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
                  mask, ref_cfg(softcap))
    return np.asarray(o, np.float32).transpose(0, 2, 1, 3)


def flash_xla_at(q, k, v, off, causal=True, window=0):
    """A function of (q, k, v) in the port's layout: the reference's
    ``_flash_xla`` (custom VJP) with queries at ``off + arange(Sq)``."""
    q_pos = jnp.arange(off, off + q.shape[2])
    k_pos = jnp.arange(k.shape[2])

    def f(q_, k_, v_):
        o = _flash_xla(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                       v_.transpose(0, 2, 1, 3), q_pos, k_pos, causal,
                       window, 8)
        return o.transpose(0, 2, 1, 3)
    return f


def ref_mask(Sq, Sk, off, causal=True, window=0):
    """The reference's ``make_mask`` at global positions, (Sq, Sk) (it
    leaves a mask without causal or window terms at one row)."""
    m = make_mask(jnp.arange(off, off + Sq), jnp.arange(Sk), causal, window)
    return np.broadcast_to(np.asarray(m), (Sq, Sk))


def keys_live(Sq, Sk, off, causal=True, window=0):
    """Whether each row has a live key."""
    return ref_mask(Sq, Sk, off, causal, window).any(-1)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_reference_at_global_positions(case):
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v = inputs(len(case), B, H, KV, Sq, Sk, hd)
    want = sdpa_at(q, k, v, off, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fa.attention_ref(tq, tk, tv, q_offset=off, **kw)
    assert_allclose(got.numpy(), want, **F32_TOL)
    split = fa.attention_split_ref(tq, tk, tv, 3, q_offset=off, **kw)
    assert_allclose(split.numpy(), want, **F32_TOL)
    bf = [t.to(torch.bfloat16) for t in (tq, tk, tv)]
    want_bf = sdpa_at(*(t.float().numpy() for t in bf), off, **kw)
    tiled = fa.attention_tiled_ref(*bf, q_offset=off, **kw)
    assert tiled.dtype == torch.bfloat16
    assert_allclose(tiled.float().numpy(), want_bf, **BF16_TOL)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if "softcap" not in CASES[c][7]])
def test_gradient_matches_reference_vjp(case):
    """``flash_attention_grad`` at an offset: the forward and dq, dk, dv
    against ``jax.vjp`` of the reference's ``_flash_xla`` at the global
    positions (its own custom VJP, its chunk of queries against every key),
    relative to each gradient's max."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v = inputs(len(case) + 1, B, H, KV, Sq, Sk, hd)
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention_grad(tq, tk, tv, q_offset=off, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    ref_o, vjp = jax.vjp(flash_xla_at(q, k, v, off, **kw),
                         *map(jnp.asarray, (q, k, v)))
    assert_allclose(out.detach().numpy(), np.asarray(ref_o), **F32_TOL)
    for name, a, b in zip("qkv", got, vjp(jnp.asarray(g))):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) or 1.0
        err = float(np.abs(a.numpy() - b).max()) / scale
        assert err <= 2e-5, f"d{name} off by {err:.2e} of its max"


def test_chunk_without_live_keys():
    """A chunk whose every row lies past the keys' window writes zeros in
    every plain version and takes a zero gradient; the reference's mask
    leaves those rows with no key (its softmax then spreads evenly, so the
    rows are held to zero here, not to it)."""
    B, H, KV, Sq, Sk, hd, off, kw = EMPTY
    assert not keys_live(Sq, Sk, off, **kw).any()
    q, k, v = map(torch.from_numpy, inputs(3, B, H, KV, Sq, Sk, hd))
    for got in (fa.attention_ref(q, k, v, q_offset=off, **kw),
                fa.attention_split_ref(q, k, v, 2, q_offset=off, **kw),
                fa.attention_tiled_ref(*(t.bfloat16() for t in (q, k, v)),
                                       q_offset=off, **kw)):
        assert torch.equal(got.float(), torch.zeros_like(q))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention_grad(tq, tk, tv, q_offset=off, **kw)
    assert torch.equal(out, torch.zeros_like(q))
    for d in torch.autograd.grad(out, (tq, tk, tv), torch.ones_like(q)):
        assert torch.equal(d, torch.zeros_like(d))
    assert cost.live_pairs(Sq, Sk, False, 4, off) == 0
    assert cost.live_keys(Sq, Sk, False, 4, off) == 0


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=9),
                                dict(causal=True, softcap=3.0),
                                dict(causal=False, window=5)])
def test_chunks_equal_the_whole_calls_rows(kw):
    """Four chunks of a 64-query sequence, each at its offset, give the
    whole call's rows [off, off + 16): the plain version bitwise, the
    tiled algebra to the bf16 tolerance (its tiles and P's rounding follow
    the chunk's rows)."""
    q, k, v = map(torch.from_numpy, inputs(4, 2, 4, 2, 64, 64, 16))
    whole = fa.attention_ref(q, k, v, **kw)
    for c in range(4):
        off = 16 * c
        part = fa.attention_ref(q[:, :, off:off + 16], k, v, q_offset=off,
                                **kw)
        assert torch.equal(part, whole[:, :, off:off + 16])
        tiled = fa.attention_tiled_ref(
            *(t.bfloat16() for t in (q[:, :, off:off + 16], k, v)),
            q_offset=off, **kw)
        assert_allclose(tiled.float().numpy(),
                        whole[:, :, off:off + 16].numpy(), **BF16_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (True, 40),
                                           (False, 6), (False, 0)])
@pytest.mark.parametrize("off", [0, 5, 31, 64, 100])
def test_live_key_tiles_never_skip_a_live_pair(causal, window, off):
    """Every (row block, key) pair that the mask leaves live at an offset
    lies in a tile ``live_key_tiles`` loads, for the kernels' blocks (64
    rows, tiles of 32 and 64 keys) and smaller ones."""
    Sq, Sk = 96, 160
    for bq, bk in ((64, 32), (64, 64), (16, 8)):
        for r0 in range(0, Sq, bq):
            r1 = min(Sq, r0 + bq) - 1
            tiles = set(fa.live_key_tiles(r0, r1, Sq, Sk, causal, window, bk,
                                          off))
            mask = ref_mask(r1 + 1 - r0, Sk, r0 + off, causal, window)
            need = {int(c) // bk for c in np.nonzero(mask.any(0))[0]}
            assert need <= tiles, (r0, bq, bk, sorted(need - tiles))


@pytest.mark.parametrize("Sq,Sk,causal,window,off", [
    (16, 64, True, 0, 0), (16, 64, True, 0, 48), (20, 80, True, 24, 60),
    (1, 8, True, 0, 5), (1, 40, True, 7, 30), (8, 32, False, 0, 24),
    (8, 16, False, 4, 40), (64, 64, True, 0, 0), (128, 512, True, 2048, 384),
    (640, 2560, True, 2048, 1920)])
def test_cost_counts_the_mask(Sq, Sk, causal, window, off):
    """``cost.live_pairs`` is the mask's count of live pairs at the offset
    and ``live_keys`` the span of keys they read; ``flash_work`` reads both
    (4 hd operations a pair; K/V bytes over the span)."""
    mask = ref_mask(Sq, Sk, off, causal, window)
    assert cost.live_pairs(Sq, Sk, causal, window, off) == int(mask.sum())
    cols = np.nonzero(mask.any(0))[0]
    span = int(cols.max() - cols.min() + 1) if cols.size else 0
    assert cost.live_keys(Sq, Sk, causal, window, off) == span
    flops, nbytes = cost.flash_work(2, 4, 2, Sq, Sk, 16, 2, 2, causal,
                                    window, off)
    assert flops == 4 * 16 * 2 * 4 * int(mask.sum())
    assert nbytes == 2 * 2 * 4 * Sq * 16 * 2 + 2 * 2 * 2 * span * 16 * 2


def test_first_causal_chunk_loads_a_quarter_of_the_last_ones_tiles():
    """Causal chunks 0-3 of a 512-token sequence: the key tiles the bf16
    kernel loads grow with the offset (chunk 0 none past its own rows, a
    quarter of chunk 3's), and the live pairs the cost formula counts are
    the triangle plus the rectangle before it."""
    S, n = 512, 128
    pairs = [cost.live_pairs(n, S, True, 0, c * n) for c in range(4)]
    assert pairs == [c * n * n + n * (n + 1) // 2 for c in range(4)]
    tiles = [len(fa.live_key_tiles(0, n - 1, n, S, True, 0, 32, c * n))
             for c in range(4)]
    assert tiles == [4, 8, 12, 16]


@pytest.mark.parametrize("Sk,causal,window,off,want", [
    (8, True, 0, 5, (0, 6)), (40, True, 7, 30, (24, 31)),
    (10, True, 0, 30, (0, 10)), (16, False, 4, 40, (16, 16)),
    (32, False, 0, 24, (0, 32)), (20, False, 6, 10, (5, 20))])
def test_decode_form_key_range(Sk, causal, window, off, want):
    """The decode form's live keys of one query at ``off``: ``[max(0, p -
    window + 1), p]`` when causal, within ``[0, Sk)``, as the mask
    says."""
    assert fa.decode_keys(Sk, causal, window, off) == want
    mask = ref_mask(1, Sk, off, causal, window)[0]
    lo, hi = want
    assert mask.sum() == hi - lo and mask[lo:hi].all()
