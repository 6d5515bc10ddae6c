"""RG-LRU gated linear recurrence (the Griffin recurrent block's scan).

  h_t = a_t ⊙ h_{t-1} + b_t, per channel, in fp32.

Layouts (the TPU kernel's):
  a, b  (B, T, C)  fp32 decay and gated input
  h0    (B, C)     fp32 incoming state
Returns h (B, T, C) and h_T (B, C), both fp32.

``rglru_btc`` takes the plain version for CPU tensors and launches the CUDA
kernel (``csrc/rglru.cu``, one thread per channel walking the tokens in
order, any T >= 1) for CUDA tensors. ``rglru_grad`` is the same function
with a gradient (``RGLRU``): its backward is the same recurrence run
backwards in time, so it calls ``rglru_btc`` again, on flipped inputs.

Cost accounting (``distributed.cost``): each call reports
``cost.rglru_work`` under the ``rgscan`` tag to an active counter,
whatever implements it, and on the ``meta`` device returns empty outputs
of the right shapes and dtypes (the dry run's path).
"""

from __future__ import annotations

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
    err = _cuda.lib().repro_rglru(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
        h_T.data_ptr(), B, T, C, *_cuda.device_and_stream(dev))
    _cuda.check_launch(name, err)
    return h, h_T


# ---------------------------------------------------------------------------
# training: the gradient
# ---------------------------------------------------------------------------

class RGLRU(torch.autograd.Function):
    """``rglru_btc`` with a gradient. The forward is the wrapper as it is
    (one kernel launch on CUDA tensors). With g_t the loss's gradient with
    respect to h_t through every later step,

      g_t = gh_t + a_{t+1} g_{t+1},   g_{T-1} = gh_{T-1} + gT,

    an RG-LRU recurrence in reversed time with decay a_next and input gh,
    started from gT: one more ``rglru_btc`` call (one launch). Then db = g,
    da = g h_{t-1} (h_{-1} = h0) and dh0 = a_0 g_0."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_T = rglru_btc(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.running = _cuda.running()
        return h, h_T

    @staticmethod
    def backward(ctx, gh, gT):
        a, h0, h = ctx.saved_tensors
        gh = torch.zeros_like(h) if gh is None else gh.float()
        gT = torch.zeros_like(h0) if gT is None else gT.float()
        a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
        with _cuda.resume(ctx.running):
            g = rglru_btc(a_next.flip(1).contiguous(),
                          gh.flip(1).contiguous(), gT.contiguous())[0]
        g = g.flip(1)
        h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
        return g * h_prev, g, a[:, 0] * g[:, 0]


def rglru_grad(a, b, h0):
    """``rglru_btc``'s contract, differentiable in a, b and h0."""
    return RGLRU.apply(a, b, h0)
