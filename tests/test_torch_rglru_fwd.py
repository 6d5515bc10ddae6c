"""RG-LRU's forward on the CPU: the staged kernel's plan
(``rglru.staged_plan``: its tiles, ring and shared memory, from the shapes
alone), the order it walks them in (``rglru_staged_ref``) bitwise the plain
version ``rglru_ref``, and the plain version against the reference's Pallas
kernel in interpret mode and its token-serial oracle at ragged shapes. The
kernels themselves run on the card: tests/test_torch_cuda.py.

Inputs come from numpy seeds: a = sigmoid(N(0, 1)), b = 0.3 N(0, 1), h0
N(0, 1), as the reference's kernel test draws them; against the reference
1e-5 (its ``test_kernels.py``'s tolerance)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro_torch.kernels import rglru  # noqa: E402

# an H100: SMs, shared memory an SM (228 KB), the system's share of it a
# block, the most a block may take, threads and blocks an SM
H100_SMS, SM_SMEM, BLOCK_RESERVED, BLOCK_SMEM = 132, 233472, 1024, 232448
SM_THREADS, SM_BLOCKS = 2048, 32
L, W = rglru.STAGE_TOKENS, rglru.WIDTH
# the port's path shapes (recurrentgemma-2b's prefill, its train step, phase
# 11a's mesh step, a tensor-parallel rank of 4) and smaller and larger ones
PATH_SHAPES = [(8, 2560, 2560), (4, 2560, 2560), (4, 512, 2560),
               (4, 512, 640)]
PLAN_SHAPES = PATH_SHAPES + [(1, 32, 4), (1, 2560, 2560), (64, 2560, 2560),
                             (3, 100, 48), (2, 40, 1000), (16, 4096, 640),
                             (4, 65, 2600), (1, 640, 640)]


def case(seed, B, T, C):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, T, C))))).astype(np.float32)
    b = (0.3 * rng.normal(size=(B, T, C))).astype(np.float32)
    return a, b, rng.normal(size=(B, C)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def resident(plan):
    """Blocks of ``plan`` an H100 SM holds at once: by shared memory (with
    the system's share a block), by threads (a consumer a channel, then
    the producer warp) and by the most blocks an SM."""
    return min(SM_SMEM // (plan.smem + BLOCK_RESERVED),
               SM_THREADS // (W + 32), SM_BLOCKS)


@pytest.mark.parametrize("B,T,C", PLAN_SHAPES)
def test_staged_plan_covers_every_channel_once(B, T, C):
    """Every channel in exactly one tile of ``WIDTH`` (a tile row a
    multiple of the 16 B the copy engine moves) or fewer at the end; the
    grid is (tiles, B); the ring 2 stages deep or more, unless T has
    fewer, and no deeper than T's stages or ``MAX_DEPTH``; a block's
    shared memory the ring's stages, barriers and 128 B to align it,
    within the 227 KB a block may take."""
    plan = rglru.staged_plan(B, T, C, H100_SMS)
    assert W * 4 % 16 == 0
    tiles = rglru.staged_tiles(C)
    seen = np.zeros(C, int)
    for c0, c1 in tiles:
        assert c0 % W == 0 and 0 < c1 - c0 <= W
        seen[c0:c1] += 1
    assert (seen == 1).all()
    assert plan.grid == (len(tiles), B)
    stages = -(-T // L)
    assert min(2, stages) <= plan.depth <= min(stages, rglru.MAX_DEPTH)
    assert plan.smem == plan.depth * (L * W * 8 + 16) + 128
    assert plan.smem <= BLOCK_SMEM == 227 * 1024
    assert rglru.staged_plan(B, T, C, H100_SMS) == plan


@pytest.mark.parametrize("B,T,C", PATH_SHAPES)
def test_staged_plan_runs_the_grid_in_one_wave(B, T, C):
    """At the path's shapes on an H100's 132 SMs: a grid of at most two
    blocks an SM is resident at once (one wave) and its rings hold
    ``FLIGHT_BYTES`` (2 MiB) of a and b or more; a larger one (the
    prefill's 320 blocks) runs in waves of one block an SM, each ring
    ``WAVE_DEPTH`` stages deep, the whole card holding more than
    ``FLIGHT_BYTES``."""
    plan = rglru.staged_plan(B, T, C, H100_SMS)
    blocks = plan.grid[0] * plan.grid[1]
    ring = plan.depth * L * W * 8
    if blocks <= 2 * H100_SMS:
        assert blocks <= H100_SMS * resident(plan)
        assert blocks * ring >= rglru.FLIGHT_BYTES == 2 * 1024 * 1024
    else:
        assert (B, T, C) == (8, 2560, 2560)
        assert plan.depth == rglru.WAVE_DEPTH and resident(plan) == 1
        assert H100_SMS * ring >= rglru.FLIGHT_BYTES


def test_staged_plan_at_the_path_shapes():
    """The plans the card runs: 320 blocks in waves of one an SM with
    rings of 8 at 8 x 2560 channels; 160 blocks, all resident, with rings
    of 2 at 4 x 2560; 40 blocks with rings of 4 at the tensor-parallel
    rank's 640 (fewer blocks than SMs: deeper rings)."""
    got = {s: rglru.staged_plan(*s, H100_SMS)[:2] for s in PATH_SHAPES}
    assert got == {(8, 2560, 2560): (8, (40, 8)),
                   (4, 2560, 2560): (2, (40, 4)),
                   (4, 512, 2560): (2, (40, 4)),
                   (4, 512, 640): (4, (10, 4))}


@pytest.mark.parametrize("sms", [66, 132, 160, 320])
def test_staged_plan_reads_waves_from_the_sm_count(sms):
    """The same shape's plan follows the card: the prefill's 320 blocks
    take rings of ``WAVE_DEPTH`` where they are more than two an SM, and
    the resident rule's rings (2 MiB across the grid, >= 2 stages)
    elsewhere; 160 blocks do on every card from 80 SMs up."""
    prefill = rglru.staged_plan(8, 2560, 2560, sms)
    train = rglru.staged_plan(4, 2560, 2560, sms)
    assert prefill.depth == (rglru.WAVE_DEPTH if 320 > 2 * sms else 2)
    assert train.depth == (rglru.WAVE_DEPTH if 160 > 2 * sms else 2)
    assert prefill.grid == (40, 8) and train.grid == (40, 4)


@pytest.mark.parametrize("B,T,C", [(1, L - 1, 64), (2, L, 64), (2, L + 1, 40),
                                   (1, 2 * L + 1, 48), (3, 100, 36),
                                   (2, 5 * L + 7, 136), (1, 40, 4),
                                   (2, 70, 200)])
def test_staged_order_is_bitwise_the_plain_version(B, T, C):
    """T = L - 1, L, L + 1 and 2L + 1 around a stage, short last tiles (C
    36-200 at W 64): the staged walk's h and h_T bitwise
    ``rglru_ref``'s."""
    a, b, h0 = (t(x) for x in case(B * T + C, B, T, C))
    h, h_T = rglru.rglru_staged_ref(a, b, h0)
    want, want_T = rglru.rglru_ref(a, b, h0)
    assert h.dtype == h_T.dtype == torch.float32
    assert torch.equal(h, want) and torch.equal(h_T, want_T)


@pytest.mark.parametrize("B,T,C", [(2, L - 1, 48), (1, L + 1, 48),
                                   (2, 2 * L + 1, 20), (3, 17, 130),
                                   (1, 65, 36)])
def test_plain_version_matches_pallas_kernel_and_oracle(B, T, C):
    """``rglru_btc`` on CPU tensors (``rglru_ref``) against the reference's
    Pallas kernel in interpret mode and its token-serial oracle at ragged
    shapes around a stage, to 1e-5."""
    a, b, h0 = case(T + C, B, T, C)
    h, h_T = rglru.rglru_btc(t(a), t(b), t(h0))
    for h_ref, hT_ref in (ref_ops.rglru(*map(jnp.asarray, (a, b, h0)),
                                        interpret=True),
                          ref_oracles.rglru_ref(*map(jnp.asarray,
                                                     (a, b, h0)))):
        assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5, rtol=1e-5)
        assert_allclose(h_T.numpy(), np.asarray(hT_ref), atol=1e-5,
                        rtol=1e-5)


def test_staged_fits_only_where_tensor_maps_can_go():
    """The staged form takes T >= one stage, C % 4 == 0 and 16-byte
    aligned a and b; decode (T = 1), C = 130 and a view 4 bytes off an
    aligned base take the serial form."""
    def fits(B, T, C, off=0):
        x = torch.zeros(B * T * C + off)[off:].view(B, T, C)
        return rglru.staged_fits(x, x)
    assert fits(4, 512, 640) and fits(2, L, 48)
    assert not fits(8, 1, 2560) and not fits(2, L - 1, 48)
    assert not fits(3, 64, 130)
    assert not fits(2, 64, 48, off=1) and fits(2, 64, 48, off=4)
