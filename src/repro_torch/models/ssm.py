"""RWKV-6 (Finch) time mix and channel mix; the Griffin recurrent block
(temporal conv + RG-LRU).

Projections run over the whole sequence; the recurrences always go through
``kernels.ops`` (the CUDA kernels on the card, their plain versions on the
CPU), the reference's ``ssm_impl="pallas"`` branch: ``ops.wkv6`` for
RWKV-6, ``ops.rglru`` for the RG-LRU.

State dicts (decode cache and prefill output), one per layer:
  rwkv:  {"S": (B,H,K,K) fp32, "shift_tm": (B,d) fp32, "shift_cm": (B,d) fp32}
  rglru: {"h": (B,C) fp32, "conv": (B,W-1,C) fp32}

In a tensor-parallel train step (``distributed.sharding``) the time mix
computes this rank's heads (``tm/w[rkvg]`` column-parallel, ``tm/wo``
row-parallel; the decay LoRA's ``bw``, ``w0``, ``u`` and the group norm
replicated and sliced to them), the channel mix its slice of ``d_ff``
(``wck`` / ``wcv``, ``wcr`` whole), and the Griffin block its lru channels
(``win`` / ``wgate`` / ``conv_w`` and the gates' columns, ``wout``
row-parallel), the gates' input ``u`` gathered over ``model`` once a block
(``wr`` / ``wi`` take all of it). A kernel runs on the rank's heads or
channels; the states it returns are theirs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.kernels import ops as kops
from repro_torch.models.common import cast, cast_part, torch_dtype, weight

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
    a, b = getattr(p, f"a_{s}"), getattr(p, f"b_{s}")
    lora = sharding.dot(torch.tanh(sharding.dot(xx, a, cast(a, cdt))), b,
                        cast(b, cdt))
    return x + dx * (cast(getattr(p, f"mu_{s}"), x.dtype) + lora)


def rwkv_streams(p, x, shift_prev, cfg, part=None, use="local"):
    """r, k, v, g and logw (fp32, in [-e^5, -1e-6]) for a whole sequence.
    x (B,T,d); shift_prev (B,d) is the token before x[:, 0]. ``part``: in a
    tensor-parallel step, this rank's channels (its heads), each product's
    input behind ``copy_to_model``; ``use`` the projections' gather."""
    cdt = x.dtype
    xs = torch.cat([shift_prev[:, None].to(cdt), x[:, :-1]], dim=1)
    dx = xs - x
    xx = x + dx * cast(p.mu_x, cdt)

    def into(s):
        m = _ddlerp(p, s, x, dx, xx)
        return m if part is None else sharding.copy_to_model(m)
    r, k, v, g = (sharding.dot(into(s), w, cast(w, cdt, use))
                  for s, w in zip("rkvg", (p.wr, p.wk, p.wv, p.wg)))
    g = F.silu(g)
    lora = torch.tanh(sharding.dot(_ddlerp(p, "w", x, dx, xx), p.aw,
                                   cast(p.aw, cdt)))
    if part is not None:
        lora = sharding.copy_to_model(lora)
    if sharding.data2d() is None:
        decay = lora @ cast_part(p.bw, cdt, part)
    else:       # bw's "data2d" dim is the channels: all of them, then part
        decay = sharding.dot(lora, p.bw, cast(p.bw, cdt, "partial"))
        decay = decay if part is None else decay[..., part]
    logw = -torch.exp(torch.clamp(
        cast_part(p.w0, torch.float32, part) + decay.float(), -12.0, 5.0))
    return r, k, v, g, torch.clamp(logw, max=-1e-6)


def _heads(x, K):
    """(B,T,d) -> (B,H,T,K), contiguous for the kernel."""
    B, T, d = x.shape
    return x.reshape(B, T, d // K, K).transpose(1, 2).contiguous()


def _timemix_split(p, cfg):
    """(this rank's channels of the time mix, the gather of its head-split
    projections): in a tensor-parallel step that splits ``tm/w[rkvg]``
    over ``model`` at whole heads, the rank's heads' channels and "local";
    where the heads do not divide, None and "whole" (the layer computes
    whole on every rank); off a split None and "local"."""
    if sharding.split_lo(p.wr, 1) is None:
        return None, "local"
    if (cfg.d_model // cfg.rwkv_head_dim) % sharding.tp().size:
        return None, "whole"
    return sharding.rank_slice(cfg.d_model), "local"


def rwkv_timemix(p, x, state, cfg):
    """Time-mix layer over a sequence (any T >= 1: a prompt or one decode
    token). Returns (y, new_state); in a tensor-parallel step the state's
    ``S`` holds this rank's heads."""
    B, T, d = x.shape
    K = cfg.rwkv_head_dim
    part, use = _timemix_split(p, cfg)
    r, k, v, g, logw = rwkv_streams(p, x, state["shift_tm"], cfg, part, use)
    H = r.shape[-1] // K
    u = cast_part(p.u, torch.float32, part).reshape(H, K).contiguous()
    s0 = state["S"]
    if part is not None and s0.shape[1] != H:     # every head's (fresh)
        s0 = s0[:, sharding.rank_slice(d // K)].contiguous()
    y, S = kops.wkv6(_heads(r, K), _heads(k, K), _heads(v, K),
                     _heads(logw, K), u, s0)
    # per-head group norm, in fp32
    yg = y.transpose(1, 2).float()                                # (B,T,H,K)
    mu = yg.mean(-1, keepdim=True)
    var = yg.var(-1, keepdim=True, correction=0)
    yg = ((yg - mu) * torch.rsqrt(var + cfg.norm_eps)).reshape(B, T, H * K)
    y = (yg * cast_part(p.gn_scale, torch.float32, part)
         + cast_part(p.gn_bias, torch.float32, part)).to(x.dtype)
    y = sharding.dot(y * g, p.wo, cast(p.wo, x.dtype, use))
    if part is not None:
        y = sharding.reduce_from_model(y)
    new_state = {"S": S, "shift_tm": x[:, -1].float(),
                 "shift_cm": state["shift_cm"]}
    return y, new_state


def rwkv_channelmix(p, x, state, cfg):
    """Channel-mix layer (squared-ReLU key, sigmoid receptance). Returns
    (y, state with shift_cm advanced)."""
    cdt = x.dtype
    xs = torch.cat([state["shift_cm"][:, None].to(cdt), x[:, :-1]], dim=1)
    dx = xs - x
    xk = x + dx * cast(p.mu_ck, cdt)
    xr = x + dx * cast(p.mu_cr, cdt)
    split = sharding.split_lo(p.wck, 1) is not None
    if split:
        xk = sharding.copy_to_model(xk)
    kk = torch.square(torch.relu(sharding.dot(xk, p.wck, cast(p.wck, cdt))))
    kv = sharding.dot(kk, p.wcv, cast(p.wcv, cdt))
    if split:
        kv = sharding.reduce_from_model(kv)
    y = torch.sigmoid(sharding.dot(xr, p.wcr, cast(p.wcr, cdt))) * kv
    return y, dict(state, shift_cm=x[:, -1].float())


# ---------------------------------------------------------------------------
# Griffin recurrent block (temporal conv + RG-LRU)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


class Rglru(nn.Module):
    """The reference's ``init_rglru`` leaves, under its keys: the input and
    gate projections ``win``/``wgate``, the depthwise conv ``conv_w``/
    ``conv_b``, the recurrence and input gates ``wr``/``br``, ``wi``/``bi``,
    ``lam`` (the logit of a ~ U(0.9, 0.999)) and the output ``wout``."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        d, C, W = cfg.d_model, cfg.lru_width, cfg.conv_width
        dt = torch_dtype(cfg.param_dtype)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dt),
                                requires_grad=False)

        self.win = weight(gen, (d, C), d, dt)
        self.wgate = weight(gen, (d, C), d, dt)
        self.conv_w = weight(gen, (W, C), W, dt)
        self.conv_b = zeros(C)
        self.wr = weight(gen, (C, C), C, dt)
        self.br = zeros(C)
        self.wi = weight(gen, (C, C), C, dt)
        self.bi = zeros(C)
        self.lam = zeros(C)
        if gen is not None:
            a = torch.rand(C, generator=gen, device=gen.device)
            a = a.mul_(0.999 - 0.9).add_(0.9)
            self.lam.data.copy_(torch.log(a / (1 - a)))
        self.wout = weight(gen, (C, d), C, dt)


def init_rglru_state(cfg, batch, device=None, dtype=torch.float32):
    return {"h": torch.zeros((batch, cfg.lru_width), dtype=dtype,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                                dtype=dtype, device=device)}


def _rglru_gates(p, u, part=None):
    """u (B,T,C) post-conv branch -> (a fp32, gated input b fp32). In a
    tensor-parallel step ``u`` is this rank's lru channels ``part``: the
    gates' products take all of them (``wr`` / ``wi`` are (C, C), split by
    their columns), gathered over ``model``."""
    u_all = u if part is None else sharding.copy_to_model(
        sharding.gather_from_model(u))
    r = torch.sigmoid(u_all @ cast(p.wr, u.dtype)
                      + cast_part(p.br, u.dtype, part))
    i = torch.sigmoid(u_all @ cast(p.wi, u.dtype)
                      + cast_part(p.bi, u.dtype, part))
    log_a0 = F.logsigmoid(cast_part(p.lam, torch.float32, part))    # (C,)
    log_a = RGLRU_C * r.float() * log_a0                           # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) \
        * (i * u).float()
    return a, b


def causal_conv1d(u, w, b, prev, part=None):
    """Depthwise causal conv as the reference writes it: a sum of W
    shifted products plus the bias. u (B,T,C); w (W,C); prev (B,W-1,C) the
    inputs before u[:, 0] (``part`` of the channels in a tensor-parallel
    step, ``w`` the rank's shard and ``b`` sliced). Returns (out (B,T,C),
    the last W-1 inputs)."""
    W, T = w.shape[0], u.shape[1]
    x = torch.cat([prev.to(u.dtype), u], dim=1)
    w = cast(w, u.dtype)
    out = sum(x[:, i:i + T] * w[i] for i in range(W))
    return out + cast_part(b, u.dtype, part), x[:, -(W - 1):]


def rglru_block(p, x, state, cfg):
    """The Griffin recurrent block over a sequence (any T >= 1: a prompt or
    one decode token). x (B,T,d); products in x's dtype with the weights
    cast to it, as the reference computes (fp32 for recurrentgemma, whose
    residual stream is fp32). Returns (y, new_state); in a tensor-parallel
    step the state holds this rank's lru channels."""
    cdt = x.dtype
    part = None
    h0, prev = state["h"], state["conv"]
    if sharding.split_lo(p.win, 1) is not None:
        part = sharding.rank_slice(cfg.lru_width)
        x = sharding.copy_to_model(x)
        if h0.shape[-1] == cfg.lru_width:      # every channel's (fresh)
            h0, prev = h0[:, part].contiguous(), prev[..., part]
    gate = F.gelu(sharding.dot(x, p.wgate, cast(p.wgate, cdt)),
                  approximate="tanh")
    u = sharding.dot(x, p.win, cast(p.win, cdt))
    u, conv_state = causal_conv1d(u, p.conv_w, p.conv_b, prev, part)
    a, b = _rglru_gates(p, u, part)
    h, h_T = kops.rglru(a, b, h0)
    y = sharding.dot(gate * h.to(cdt), p.wout, cast(p.wout, cdt))
    if part is not None:
        y = sharding.reduce_from_model(y)
    return y, {"h": h_T, "conv": conv_state.float()}
