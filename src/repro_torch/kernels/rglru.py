"""RG-LRU gated linear recurrence (the Griffin recurrent block's scan).

  h_t = a_t ⊙ h_{t-1} + b_t, per channel, in fp32.

Layouts (the TPU kernel's):
  a, b  (B, T, C)  fp32 decay and gated input
  h0    (B, C)     fp32 incoming state
Returns h (B, T, C) and h_T (B, C), both fp32.

``rglru_btc`` takes the plain version for CPU tensors and launches a CUDA
kernel (``csrc/rglru.cu``) for CUDA tensors, in one of two forms, both
bitwise the plain version, counted in ``_cuda.forms["rglru_btc"]``:
``staged`` (``rglru_staged_kernel``: a block a tile of ``WIDTH`` channels
of one row, fed by the copy engine (tensor-map boxes) through a ring of
stages in shared memory as deep as ``staged_plan`` says) where
``staged_fits`` (T >= ``STAGE_TOKENS``, C % 4 == 0, a and b 16-byte
aligned), ``serial`` (``rglru_kernel``: one thread per channel)
elsewhere, as at decode (T = 1). ``rglru_staged_ref`` walks the staged
form's tiles and stages in its order. ``rglru_grad`` is the same function
with a gradient (``RGLRU``): its backward, ``rglru_bwd``, is the same
recurrence run backwards in time with da, db and dh0 taken on the way,
one launch of the gradient kernel (``rglru_bwd_kernel``, one thread per
channel walking the tokens from the last) on CUDA tensors and its plain
version ``rglru_bwd_ref`` on CPU tensors; ``_cuda.forms`` counts that
launch under ``rglru_btc``'s ``backward`` form.

Cost accounting (``distributed.cost``): each call reports
``cost.rglru_work`` (a backward ``cost.rglru_bwd_work``) under the
``rgscan`` tag to an active counter, whatever implements it, and on the
``meta`` device returns empty outputs of the right shapes and dtypes (the
dry run's path).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed import cost
from repro_torch.kernels import _cuda


def rglru_ref(a, b, h0):
    """Plain version of ``rglru_btc``: the token-serial recurrence of
    ``repro.kernels.ref.rglru_ref``, a multiply then an add per token (each
    rounded on its own, as the kernel rounds them)."""
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


# the staged form's layout (``csrc/rglru.cu``): tokens a ring stage,
# channels a tile, the bytes of a and b the whole grid's rings aim to hold
# (Little's law: 3.35 TB/s x ~0.6 us of DRAM latency), the ring of a grid
# that runs in waves (8 stages of 16 KB: 131 KB, so one block an SM), the
# deepest ring (12 stages: 197 KB, within a block's 227 KB)
STAGE_TOKENS = 32
WIDTH = 64
FLIGHT_BYTES = 2 << 20
WAVE_DEPTH = 8
MAX_DEPTH = 12


class StagedPlan(NamedTuple):
    depth: int         # stages in the ring
    grid: tuple        # (ceil(C / WIDTH), B) blocks
    smem: int          # dynamic shared memory a block, bytes


def staged_tiles(C):
    """The channel ranges [c0, c1) of the staged form's grid's x axis."""
    return [(c0, min(c0 + WIDTH, C)) for c0 in range(0, C, WIDTH)]


def staged_plan(B, T, C, sms):
    """The staged form's layout at (B, T, C) on a card of ``sms`` SMs, from
    those alone: a block a tile of ``WIDTH`` channels of one row. A grid of
    more than two blocks an SM runs in waves of one block an SM, each with
    a ring of ``WAVE_DEPTH`` stages; a smaller grid is resident at once,
    with rings deep enough to hold ``FLIGHT_BYTES`` of a and b across it
    (``STAGE_TOKENS`` x ``WIDTH`` x 8 B a stage), at least 2 stages, so
    fewer blocks than SMs get deeper rings. Never deeper than
    ``MAX_DEPTH`` or T's stages. Shared memory: the ring, 16 B of barriers
    a stage, 128 B to align it. Any depth gives the same bits. On the H100
    (PERF.md §6): 320 blocks ran 0.2133 ms with rings of 8 against 0.2203
    with 2-4, which keep them all resident; 160 blocks ran 0.1061 with
    rings of 2 against 0.1142 with 3 and 0.1185 with 8 (two waves); 40
    blocks 0.0089 with 3-4 against 0.0107 with 2."""
    grid = (-(-C // WIDTH), B)
    blocks = grid[0] * B
    stage = STAGE_TOKENS * WIDTH * 8
    depth = WAVE_DEPTH if blocks > 2 * sms else \
        max(2, -(-FLIGHT_BYTES // (blocks * stage)))
    depth = max(1, min(depth, MAX_DEPTH, -(-T // STAGE_TOKENS)))
    return StagedPlan(depth, grid, depth * (stage + 16) + 128)


def staged_fits(a, b):
    """Whether the staged form takes these inputs: T >= one stage, C % 4
    == 0, and a and b 16-byte aligned, as their tensor maps need (a row's
    stride and the bases multiples of 16 bytes)."""
    _, T, C = a.shape
    return T >= STAGE_TOKENS and C % 4 == 0 \
        and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0


def rglru_staged_ref(a, b, h0):
    """The staged form's order: for each row and tile (``staged_tiles``),
    the stages of ``STAGE_TOKENS`` tokens one after another, each token a
    multiply then an add over the tile's channels. Bitwise ``rglru_ref``:
    each channel's steps are the same."""
    B, T, C = a.shape
    af, bf = a.float(), b.float()
    h = torch.empty_like(af)
    h_T = torch.empty_like(h0, dtype=torch.float32)
    for r in range(B):
        for c0, c1 in staged_tiles(C):
            hv = h0[r, c0:c1].float()
            for t0 in range(0, T, STAGE_TOKENS):
                for t in range(t0, min(t0 + STAGE_TOKENS, T)):
                    hv = af[r, t, c0:c1] * hv + bf[r, t, c0:c1]
                    h[r, t, c0:c1] = hv
            h_T[r, c0:c1] = hv
    return h, h_T


def rglru_btc(a, b, h0):
    """a/b (B,T,C) fp32; h0 (B,C) fp32. Returns h (B,T,C) fp32 and h_T
    (B,C) fp32."""
    with cost.counted("rgscan", lambda: cost.rglru_work(*a.shape)):
        if a.device.type == "meta":
            return (torch.empty_like(a, dtype=torch.float32),
                    torch.empty_like(h0, dtype=torch.float32))
        if a.device.type == "cpu":
            return rglru_ref(a, b, h0)
        if a.device.type != "cuda":
            raise ValueError(f"rglru_btc: no kernel for {a.device}")
        return _launch(a, b, h0)


def _launch(a, b, h0):
    name = "rglru_btc"
    f32 = (torch.float32,)
    dev = _cuda.check_cuda_tensors(name, (a, b, h0), (f32, f32, f32))
    B, T, C = a.shape
    if b.shape != a.shape or h0.shape != (B, C) or T < 1 or B > 65535:
        raise ValueError(f"{name}: shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 {tuple(h0.shape)}")
    h = torch.empty_like(a)
    h_T = torch.empty_like(h0)
    if B * C == 0:
        return h, h_T
    ptrs = (a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
            h_T.data_ptr(), B, T, C)
    if staged_fits(a, b):
        plan = staged_plan(B, T, C, _cuda.sm_count(dev))
        err = _cuda.lib().repro_rglru_staged(
            *ptrs, plan.depth, *_cuda.device_and_stream(dev))
        _cuda.check_launch(name, err, "staged")
    else:
        err = _cuda.lib().repro_rglru(*ptrs, *_cuda.device_and_stream(dev))
        _cuda.check_launch(name, err, "serial")
    return h, h_T


# ---------------------------------------------------------------------------
# training: the gradient
# ---------------------------------------------------------------------------

def rglru_bwd_ref(a, h, h0, gh, gT):
    """Plain version of ``rglru_bwd``: with g_T = gT, g_t = a_{t+1} g_{t+1}
    + gh_t (a_T = 1), a multiply then an add per token, t = T-1 .. 0; db_t
    = g_t, da_t = g_t h_{t-1} (h_{-1} = h0), dh0 = a_0 g_0. gh and gT may
    be None (zeros). The kernel rounds each step as this does."""
    B, T, C = a.shape
    af, hf, h0f = a.float(), h.float(), h0.float()
    g = torch.zeros_like(h0f) if gT is None else gT.float()
    gh = torch.zeros_like(af) if gh is None else gh.float()
    da, db = torch.empty_like(af), torch.empty_like(af)
    one = torch.ones_like(h0f)
    for t in reversed(range(T)):
        g = (af[:, t + 1] if t + 1 < T else one) * g + gh[:, t]
        db[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else h0f)
    return da, db, af[:, 0] * g


def rglru_bwd(a, h, h0, gh, gT):
    """The gradients (da, db (B,T,C), dh0 (B,C), fp32) of ``rglru_btc`` at
    the upstream gh (B,T,C) and gT (B,C), either None for zero, from the
    forward's a, h (B,T,C) and h0 (B,C), all fp32. CPU tensors:
    ``rglru_bwd_ref``; CUDA tensors: the gradient kernel, one launch
    counted under the ``backward`` form."""
    with cost.counted("rgscan", lambda: cost.rglru_bwd_work(*a.shape)):
        if a.device.type == "meta":
            return (torch.empty_like(a, dtype=torch.float32),
                    torch.empty_like(a, dtype=torch.float32),
                    torch.empty_like(h0, dtype=torch.float32))
        if a.device.type == "cpu":
            return rglru_bwd_ref(a, h, h0, gh, gT)
        if a.device.type != "cuda":
            raise ValueError(f"rglru_bwd: no kernel for {a.device}")
        return _launch_bwd(a, h, h0, gh, gT)


def _launch_bwd(a, h, h0, gh, gT):
    name = "rglru_btc"
    f32 = (torch.float32,)
    tensors = [a, h, h0] + [x for x in (gh, gT) if x is not None]
    dev = _cuda.check_cuda_tensors(name, tensors, (f32,) * len(tensors))
    B, T, C = a.shape
    if h.shape != a.shape or h0.shape != (B, C) or T < 1 or B > 65535 \
            or (gh is not None and gh.shape != a.shape) \
            or (gT is not None and gT.shape != (B, C)):
        raise ValueError(
            f"{name} backward: shapes a {tuple(a.shape)}, h "
            f"{tuple(h.shape)}, h0 {tuple(h0.shape)}, gh "
            f"{None if gh is None else tuple(gh.shape)}, gT "
            f"{None if gT is None else tuple(gT.shape)}")
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), \
        torch.empty_like(h0)
    if B * C == 0:
        return da, db, dh0
    err = _cuda.lib().repro_rglru_bwd(
        a.data_ptr(), h.data_ptr(), h0.data_ptr(),
        None if gh is None else gh.data_ptr(),
        None if gT is None else gT.data_ptr(), da.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), B, T, C, *_cuda.device_and_stream(dev))
    _cuda.check_launch(name, err, "backward")
    return da, db, dh0


class RGLRU(torch.autograd.Function):
    """``rglru_btc`` with a gradient. The forward is the wrapper as it is
    (one kernel launch on CUDA tensors). With g_t the loss's gradient with
    respect to h_t through every later step,

      g_t = gh_t + a_{t+1} g_{t+1},   g_{T-1} = gh_{T-1} + gT,

    an RG-LRU recurrence in reversed time; db = g, da = g h_{t-1} (h_{-1} =
    h0) and dh0 = a_0 g_0. The backward is ``rglru_bwd``: on CUDA tensors
    one launch of the gradient kernel, which walks the tokens from the last
    and writes the three gradients itself (no flipped copies); autograd
    runs it on a thread of its own, and its launch counts where the
    forward's did (``_cuda.resume``)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_T = rglru_btc(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.running = _cuda.running()
        return h, h_T

    @staticmethod
    def backward(ctx, gh, gT):
        a, h0, h = ctx.saved_tensors
        gh, gT = (None if x is None else x.float() for x in (gh, gT))
        if a.device.type == "cuda":
            a, h0, h = (_cuda.fresh(x) for x in (a, h0, h))
            gh, gT = (None if x is None else _cuda.fresh(x)
                      for x in (gh, gT))
        with _cuda.resume(ctx.running):
            return rglru_bwd(a, h, h0, gh, gT)


def rglru_grad(a, b, h0):
    """``rglru_btc``'s contract, differentiable in a, b and h0."""
    return RGLRU.apply(a, b, h0)
