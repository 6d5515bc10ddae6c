"""The paged decode kernel's split algebra on the CPU.

``paged_decode_split_ref`` repeats the CUDA kernel's order of operations
(each row's keys cut into ranges from its own length, 32-key tiles with a
running max and sum, then the fp32 combine, or the direct normalise with
one range). It is held to the reference's Pallas kernel
``repro.kernels.paged_attention.paged_decode_bkgh`` run in interpret mode
and to the port's plain ``paged_decode_ref``, over rows of length 0, 1, 7,
8, 9 and the full capacity, pages in a scrambled pool order, a trash page
full of NaN behind every page past a row's length, G 1, 2 and 4, hd 16 and
32, and 1 to 5 ranges (more than a row has tiles). ``paged_decode_splits``
is checked to depend on static shapes alone. The kernel itself runs on the
card: tests/test_torch_cuda.py.

Inputs come from numpy seeds. Tolerance: 1e-5 in fp32
(``tests/test_paged_decode.py``'s own)."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import paged_attention as ref_pa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KV, PAGE, MAXP = 2, 8, 9                 # 72 keys a row: 3 tiles of 32
LENGTHS = (0, 1, 7, 8, 9, MAXP * PAGE, 40, 65)
_JAX = {}


def paged_case(seed, G, hd, lengths):
    """q, pools, block tables and lengths (numpy): every row's live pages
    drawn from a scrambled pool, every page past its length the trash page
    (the pool's last), which holds NaN."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    P = B * MAXP + 1
    trash = P - 1
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kp = rng.normal(size=(P, KV, PAGE, hd)).astype(np.float32)
    vp = rng.normal(size=(P, KV, PAGE, hd)).astype(np.float32)
    kp[trash] = vp[trash] = np.nan
    order = rng.permutation(P - 1)
    bt = np.full((B, MAXP), trash, np.int32)
    for b, n in enumerate(lengths):
        live = -(-n // PAGE)
        bt[b, :live] = order[b * MAXP:b * MAXP + live]
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def reference(case, key):
    """The reference Pallas kernel in interpret mode, once per case."""
    if key not in _JAX:
        _JAX[key] = np.asarray(ref_pa.paged_decode_bkgh(
            *map(jnp.asarray, case), page_size=PAGE, interpret=True))
    return _JAX[key]


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_split_ref_matches_reference_kernel_and_plain(G, hd, n_split):
    """Every row, inactive and full ones included, through 1 to 5 ranges:
    the reference kernel's output and the plain version's, to 1e-5; no NaN
    from the trash page; inactive rows exactly zero."""
    case = paged_case(G * 100 + hd, G, hd, LENGTHS)
    want = reference(case, (G, hd))
    args = [torch.from_numpy(a) for a in case]
    got = pa.paged_decode_split_ref(*args, page_size=PAGE,
                                    n_split=n_split).numpy()
    plain = pa.paged_decode_ref(*args, page_size=PAGE).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert_allclose(got, want, **TOL)
    assert_allclose(plain, want, **TOL)
    assert_allclose(got, plain, **TOL)
    assert np.all(got[case[4] == 0] == 0.0)


@pytest.mark.parametrize("n_split", [1, 3])
def test_split_ref_all_rows_inactive(n_split):
    """Every row of length 0, every page the NaN trash page: an exact zero
    output, as the reference kernel and the plain version give."""
    case = paged_case(7, 2, 32, (0,) * 5)
    args = [torch.from_numpy(a) for a in case]
    got = pa.paged_decode_split_ref(*args, page_size=PAGE, n_split=n_split)
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(pa.paged_decode_ref(*args, page_size=PAGE), got)
    assert np.all(reference(case, "inactive") == 0.0)


@pytest.mark.parametrize("n_split", [1, 4])
def test_split_ref_reads_no_key_past_a_range(n_split):
    """NaN in every key and value past each row's length, inside its last
    live page too: no output is touched by them."""
    q, kp, vp, bt, lens = paged_case(11, 2, 16, LENGTHS)
    for b, n in enumerate(lens):
        if n % PAGE:
            kp[bt[b, n // PAGE], :, n % PAGE:] = np.nan
            vp[bt[b, n // PAGE], :, n % PAGE:] = np.nan
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
    got = pa.paged_decode_split_ref(*args, page_size=PAGE, n_split=n_split)
    plain = pa.paged_decode_ref(*args, page_size=PAGE)
    assert bool(torch.isfinite(got).all())
    assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_split_ref_keeps_bf16():
    """bf16 inputs: the output in bf16, within bf16 rounding of the fp32
    run of the same inputs."""
    case = paged_case(5, 4, 32, LENGTHS)
    args = [torch.from_numpy(a) for a in case]
    want = pa.paged_decode_split_ref(*args, page_size=PAGE, n_split=2)
    args[:3] = [a.bfloat16() for a in args[:3]]
    got = pa.paged_decode_split_ref(*args, page_size=PAGE, n_split=2)
    assert got.dtype == torch.bfloat16
    assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2, rtol=2e-2)


def test_splits_come_from_static_shapes():
    """The range count never sees the lengths: they are not an argument.
    1 at the protein path's shape (24 slots x 4 KV heads, 11 pages of 8: 3
    tiles) and at a design length's (256 slots x 4, 40 pages: 1,024 blocks
    fill the card); more for a few rows of long capacity; never more than
    MAX_SPLITS; query groups past 16 take more blocks."""
    assert "lengths" not in inspect.signature(pa.paged_decode_splits) \
        .parameters
    assert pa.paged_decode_splits(24, 4, 2, 11, 8, 132) == 1
    assert pa.paged_decode_splits(256, 4, 2, 40, 8, 132) == 1
    assert pa.paged_decode_splits(2, 4, 2, 256, 8, 132) == 16
    assert pa.paged_decode_splits(1, 1, 1, 4096, 16, 132) == fa.MAX_SPLITS
    assert pa.paged_decode_splits(1, 1, 1, 7, 8, 132) == 1
    assert pa.paged_decode_splits(4, 1, 32, 256, 8, 132) == 16
    assert pa.paged_decode_splits(4, 1, 33, 256, 8, 132) == 11


def test_decode_body_fits_shared_memory():
    """The decode body's ring of three tiles fits a block's 227 KB of
    shared memory at every head dim and dtype; at the protein path's
    (hd 32, bf16) 8 blocks fit an SM."""
    for hd in fa.HEAD_DIMS:
        for elem in (2, 4):
            assert fa.decode_smem_bytes(hd, elem) <= 232_448
    assert 8 * fa.decode_smem_bytes(32, 2) <= 228 * 1024
