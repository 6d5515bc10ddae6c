"""The flash kernel's bf16 sequence form on the CPU: its algebra
(``attention_tiled_ref``: key tiles of 32, a running max and sum per row, P
rounded to bf16 before P.V, fp32 accumulation) against the port's plain
attention and the reference's Pallas kernel in interpret mode, and its
tile-skipping rule (``live_key_tiles``). The kernel itself runs on the card:
tests/test_torch_cuda.py.

Inputs come from numpy seeds, rounded to bf16 once so every side sees the
same values. Tolerance: 2e-2 in bf16 (``test_kernels.py``'s own for
flash)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import flash_attention as ref_fa  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def bf16_qkv(seed, B, H, KV, Sq, Sk, hd):
    """q (B,H,Sq,hd), k/v (B,KV,Sk,hd) as numpy fp32 holding bf16 values."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(rng.normal(size=s), jnp.bfloat16),
                       np.float32)
            for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


def torch_bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


MASKS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=9),
    "softcap": dict(causal=True, softcap=5.0),
    "non-causal": dict(causal=False),
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_tiled_ref_matches_plain_and_pallas(hd, mask):
    """Every compiled head dim, GQA (4 query heads a KV head), 40 queries
    (not a multiple of the 32-key tile): the tiled algebra, the port's
    ``attention_ref`` and the reference's Pallas kernel in interpret mode
    agree in bf16."""
    kw = MASKS[mask]
    B, H, KV, S = 1, 8, 2, 40
    q, k, v = bf16_qkv(hd, B, H, KV, S, S, hd)
    got = fa.attention_tiled_ref(*torch_bf16(q, k, v), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, hd)
    got = got.float().numpy()
    want = fa.attention_ref(*torch_bf16(q, k, v), **kw).float().numpy()
    assert_allclose(got, want, **BF16_TOL)
    bshd = [jnp.asarray(a.transpose(0, 2, 1, 3), jnp.bfloat16)
            for a in (q, k, v)]
    pallas = np.asarray(ref_ops.flash_attention(
        *bshd, block_q=32, block_k=32, interpret=True, **kw),
        np.float32).transpose(0, 2, 1, 3)
    assert_allclose(got, pallas, **BF16_TOL)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (4, 8, 8, 32, 32),     # foldscore-s predict_batch
    (1, 8, 4, 31, 32),     # progen-s admission prefill, GQA
    (1, 8, 4, 65, 32),     # progen-s frontend_seq + 1
    (1, 8, 4, 33, 32),     # one key past a tile
    (2, 10, 1, 70, 256),   # MQA, 10 query heads: blocks cut a query's heads
])
def test_tiled_ref_at_the_paths_shapes(B, H, KV, S, hd):
    """The protein path's shapes and a group of 10 heads (64-row blocks
    then hold 6.4 queries): the tiled algebra against the plain version."""
    q, k, v = bf16_qkv(S + H, B, H, KV, S, S, hd)
    got = fa.attention_tiled_ref(*torch_bf16(q, k, v)).float().numpy()
    want = fa.attention_ref(*torch_bf16(q, k, v)).float().numpy()
    assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("seq_q,seq_k,kw", [
    (50, 37, dict(causal=True)),
    (37, 64, dict(causal=True, window=12)),
    (64, 40, dict(causal=False, window=9)),     # rows >= 49 see no key
    (21, 21, dict(causal=False, softcap=7.0)),
])
def test_tiled_ref_ragged_lengths_and_rows_without_keys(seq_q, seq_k, kw):
    """Block-padded inputs (64 rows) with pre-pad lengths, as the reference
    wrapper calls its kernel: real rows agree with the Pallas kernel and
    the plain version; rows past seq_q, and rows whose window holds no key
    below seq_k, are exactly zero."""
    B, H, KV, Sp, hd = 2, 4, 2, 64, 32
    q, k, v = bf16_qkv(seq_q * seq_k, B, H, KV, Sp, Sp, hd)
    lens = dict(seq_q=seq_q, seq_k=seq_k)
    got = fa.attention_tiled_ref(*torch_bf16(q, k, v), **lens, **kw)
    got = got.float().numpy()
    want = fa.attention_ref(*torch_bf16(q, k, v), **lens, **kw)
    assert_allclose(got, want.float().numpy(), **BF16_TOL)
    pallas = np.asarray(ref_fa.flash_attention_bhsd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), block_q=32,
        block_k=32, interpret=True, **lens, **kw), np.float32)
    assert_allclose(got[:, :, :seq_q], pallas[:, :, :seq_q], **BF16_TOL)
    rows = np.arange(Sp)
    no_key = rows >= seq_q
    if kw.get("window", 0) > 0 and not kw["causal"]:
        no_key |= rows - kw["window"] + 1 >= seq_k
    assert no_key.any()
    assert np.all(got[:, :, no_key] == 0.0)


@pytest.mark.parametrize("bk", [32, 16])
def test_tiled_ref_does_not_depend_on_the_tile(bk):
    """Tiles of 16 keys give the 32-key answer to bf16 rounding: the tile
    is an algebraic choice, not part of the function."""
    q, k, v = bf16_qkv(bk, 2, 4, 2, 45, 45, 64)
    got = fa.attention_tiled_ref(*torch_bf16(q, k, v), bk, window=20)
    want = fa.attention_ref(*torch_bf16(q, k, v), window=20)
    assert_allclose(got.float().numpy(), want.float().numpy(), **BF16_TOL)


def _live(row, col, seq_q, seq_k, causal, window):
    ok = row < seq_q and col < seq_k
    if causal:
        ok = ok and col <= row
    if window > 0:
        ok = ok and col > row - window
    return ok


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0),
                                           (False, 7), (True, 40)])
def test_live_key_tiles_never_skips_a_live_pair(causal, window):
    """For every block of query positions, every tile holding a live (q, k)
    pair is in ``live_key_tiles``, and every tile it names lies below
    seq_k; with no live row it names none."""
    S = 23
    for bk, seq_q, seq_k in itertools.product((4, 8), (0, 5, 23), (0, 6, 23)):
        for row_lo in range(S):
            for row_hi in range(row_lo, S):
                tiles = fa.live_key_tiles(row_lo, row_hi, seq_q, seq_k,
                                          causal, window, bk)
                assert all(0 <= t and t * bk < seq_k for t in tiles)
                for row in range(row_lo, row_hi + 1):
                    for col in range(S):
                        if _live(row, col, seq_q, seq_k, causal, window):
                            assert col // bk in tiles, (
                                bk, seq_q, seq_k, row_lo, row_hi, row, col)
                if min(row_hi, seq_q - 1) < row_lo:
                    assert len(tiles) == 0


def test_live_key_tiles_skips_what_the_masks_exclude():
    """The rule skips: causal rows 0..31 of 96 keys load one 32-key tile,
    a window of 8 at rows 64..95 loads two of three."""
    assert list(fa.live_key_tiles(0, 31, 96, 96, True, 0, 32)) == [0]
    assert list(fa.live_key_tiles(64, 95, 96, 96, True, 8, 32)) == [1, 2]
    assert list(fa.live_key_tiles(0, 95, 40, 96, True, 0, 32)) == [0, 1]
