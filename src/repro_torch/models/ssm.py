"""RWKV-6 (Finch) time mix and channel mix.

Projections run over the whole sequence; the WKV recurrence always goes
through ``kernels.ops.wkv6`` (the CUDA kernel on the card, its plain
chunked version on the CPU), the reference's ``ssm_impl="pallas"`` branch.

State dict (decode cache and prefill output), one per layer:
  {"S": (B,H,K,K) fp32, "shift_tm": (B,d) fp32, "shift_cm": (B,d) fp32}

The Griffin / RG-LRU half of the reference module is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.common import torch_dtype, weight

LORA_MIX = 32
LORA_DECAY = 64
STREAMS = "rkvgw"


class Rwkv(nn.Module):
    """The reference's ``init_rwkv`` leaves, under its keys: token-shift
    mixes ``mu_*``, the data-dependent LoRAs ``a_*``/``b_*`` and decay LoRA
    ``aw``/``bw`` (scaled by 0.1), decay base ``w0``, bonus ``u``, the
    r/k/v/g/o projections, the group norm and the channel mix."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg.param_dtype)

        def const(values):
            return nn.Parameter(values.to(dt), requires_grad=False)

        def lora(shape, fan_in):
            p = weight(gen, shape, fan_in, dt)
            p.data.mul_(0.1)
            return p

        self.mu_x = const(torch.zeros(d))
        self.u = const(torch.full((d,), 0.5))
        self.w0 = const(torch.linspace(0.3, 6.0, d).expm1().log())
        self.aw = lora((d, LORA_DECAY), d)
        self.bw = lora((LORA_DECAY, d), LORA_DECAY)
        for name in ("wr", "wk", "wv", "wg", "wo", "wcr"):
            setattr(self, name, weight(gen, (d, d), d, dt))
        self.gn_scale = const(torch.ones(d))
        self.gn_bias = const(torch.zeros(d))
        self.mu_ck = const(torch.full((d,), 0.5))
        self.mu_cr = const(torch.full((d,), 0.5))
        self.wck = weight(gen, (d, f), d, dt)
        self.wcv = weight(gen, (f, d), f, dt)
        for s in STREAMS:
            setattr(self, f"mu_{s}", const(torch.full((d,), 0.5)))
            setattr(self, f"a_{s}", lora((d, LORA_MIX), d))
            setattr(self, f"b_{s}", lora((LORA_MIX, d), LORA_MIX))


def init_rwkv_state(cfg, batch, device=None, dtype=torch.float32):
    H = cfg.d_model // cfg.rwkv_head_dim
    K = cfg.rwkv_head_dim
    return {"S": torch.zeros((batch, H, K, K), dtype=dtype, device=device),
            "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
            "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device)}


def _ddlerp(p, s, x, dx, xx):
    """Finch data-dependent token-shift interpolation for stream s."""
    cdt = xx.dtype
    lora = torch.tanh(xx @ getattr(p, f"a_{s}").to(cdt)) \
        @ getattr(p, f"b_{s}").to(cdt)
    return x + dx * (getattr(p, f"mu_{s}").to(x.dtype) + lora)


def rwkv_streams(p, x, shift_prev, cfg):
    """r, k, v, g and logw (fp32, in [-e^5, -1e-6]) for a whole sequence.
    x (B,T,d); shift_prev (B,d) is the token before x[:, 0]."""
    cdt = x.dtype
    xs = torch.cat([shift_prev[:, None].to(cdt), x[:, :-1]], dim=1)
    dx = xs - x
    xx = x + dx * p.mu_x.to(cdt)
    r = _ddlerp(p, "r", x, dx, xx) @ p.wr.to(cdt)
    k = _ddlerp(p, "k", x, dx, xx) @ p.wk.to(cdt)
    v = _ddlerp(p, "v", x, dx, xx) @ p.wv.to(cdt)
    g = F.silu(_ddlerp(p, "g", x, dx, xx) @ p.wg.to(cdt))
    mw = _ddlerp(p, "w", x, dx, xx)
    logw = -torch.exp(torch.clamp(
        p.w0.float() + (torch.tanh(mw @ p.aw.to(cdt)) @ p.bw.to(cdt)).float(),
        -12.0, 5.0))
    return r, k, v, g, torch.clamp(logw, max=-1e-6)


def _heads(x, K):
    """(B,T,d) -> (B,H,T,K), contiguous for the kernel."""
    B, T, d = x.shape
    return x.reshape(B, T, d // K, K).transpose(1, 2).contiguous()


def rwkv_timemix(p, x, state, cfg):
    """Time-mix layer over a sequence (any T >= 1: a prompt or one decode
    token). Returns (y, new_state)."""
    B, T, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    r, k, v, g, logw = rwkv_streams(p, x, state["shift_tm"], cfg)
    u = p.u.float().reshape(H, K)
    y, S = kops.wkv6(_heads(r, K), _heads(k, K), _heads(v, K),
                     _heads(logw, K), u, state["S"])
    # per-head group norm, in fp32
    yg = y.transpose(1, 2).float()                                # (B,T,H,K)
    mu = yg.mean(-1, keepdim=True)
    var = yg.var(-1, keepdim=True, correction=0)
    yg = ((yg - mu) * torch.rsqrt(var + cfg.norm_eps)).reshape(B, T, d)
    y = (yg * p.gn_scale.float() + p.gn_bias.float()).to(x.dtype)
    y = (y * g) @ p.wo.to(x.dtype)
    new_state = {"S": S, "shift_tm": x[:, -1].float(),
                 "shift_cm": state["shift_cm"]}
    return y, new_state


def rwkv_channelmix(p, x, state, cfg):
    """Channel-mix layer (squared-ReLU key, sigmoid receptance). Returns
    (y, state with shift_cm advanced)."""
    cdt = x.dtype
    xs = torch.cat([state["shift_cm"][:, None].to(cdt), x[:, :-1]], dim=1)
    dx = xs - x
    xk = x + dx * p.mu_ck.to(cdt)
    xr = x + dx * p.mu_cr.to(cdt)
    kk = torch.square(torch.relu(xk @ p.wck.to(cdt)))
    y = torch.sigmoid(xr @ p.wcr.to(cdt)) * (kk @ p.wcv.to(cdt))
    return y, dict(state, shift_cm=x[:, -1].float())
