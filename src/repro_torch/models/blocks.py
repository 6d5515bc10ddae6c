"""Transformer and recurrent layers. The reference stacks each segment's
layers on a ``repeats`` axis and runs them with ``lax.scan``; the port keeps
one ``Layer`` module per layer in an ``nn.ModuleList`` walked by a Python
loop (``cfg.layer_kinds`` gives each layer's kind). Four kinds are ported:
the dense causal ``"attn"`` kind (the protein models, with its paged decode
path), the local-window ``"attn_local"`` kind (with its dense ring cache),
the ``"rwkv"`` kind (RWKV-6 time mix + channel mix, with its recurrent
state as the decode cache) and the ``"rglru"`` kind (the Griffin recurrent
block, with its RG-LRU and conv state)."""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import Norm, norm_fwd
from repro_torch.models.mlp import Mlp, mlp_fwd

KINDS = ("attn", "attn_local", "rwkv", "rglru")
PAGED_KINDS = ("attn",)          # kinds with a paged KV cache
# kinds with a ported dense decode cache; ``attn``'s comes with the dense
# sampler
CACHE_KINDS = ("attn_local", "rwkv", "rglru")


def check_kind(kind, ported=PAGED_KINDS):
    if kind not in ported:
        raise ValueError(f"layer kind {kind!r} is not ported for this path "
                         f"(ported: {ported})")


def _window(kind, cfg):
    return cfg.attn_window if kind == "attn_local" else 0


class Layer(nn.Module):
    """``attn`` / ``attn_local``: pre-norm causal self-attention + MLP.
    ``rglru``: pre-norm Griffin recurrent block (``rec``) + MLP. ``rwkv``:
    pre-norm time mix + channel mix, both in ``tm``."""

    def __init__(self, kind, cfg, gen=None):
        super().__init__()
        check_kind(kind, KINDS)
        self.norm1 = Norm(cfg)
        self.norm2 = Norm(cfg)
        if kind == "rwkv":
            self.tm = ssm.Rwkv(cfg, gen)
            return
        if kind == "rglru":
            self.rec = ssm.Rglru(cfg, gen)
        else:
            self.attn = attn.Attention(cfg, gen)
        self.mlp = Mlp(cfg, gen)


def _rwkv(p, x, cfg, state):
    h, state = ssm.rwkv_timemix(p.tm, norm_fwd(p.norm1, x, cfg), state, cfg)
    x = x + h
    h, state = ssm.rwkv_channelmix(p.tm, norm_fwd(p.norm2, x, cfg), state,
                                   cfg)
    return x + h, state


def _mlp_after(p, x, h, cfg):
    """Residual add of the mixer's output h, then the MLP half."""
    x = x + h
    return x + mlp_fwd(p.mlp, norm_fwd(p.norm2, x, cfg), cfg)


def _rglru(p, x, cfg, state):
    h, state = ssm.rglru_block(p.rec, norm_fwd(p.norm1, x, cfg), state, cfg)
    return _mlp_after(p, x, h, cfg), state


def layer_fwd(kind, p, x, ctx, cfg):
    """Full-sequence forward. ctx: positions (S,). Returns x."""
    check_kind(kind, KINDS)
    if kind == "rwkv":
        return _rwkv(p, x, cfg, ssm.init_rwkv_state(cfg, x.shape[0],
                                                    device=x.device))[0]
    if kind == "rglru":
        return _rglru(p, x, cfg, ssm.init_rglru_state(cfg, x.shape[0],
                                                      device=x.device))[0]
    h = attn.attn_fwd(p.attn, norm_fwd(p.norm1, x, cfg), ctx["positions"],
                      cfg, window=_window(kind, cfg))
    return _mlp_after(p, x, h, cfg)


def init_layer_cache(kind, cfg, batch, length, device=None):
    """The decode cache of one layer: the ring K/V cache of an
    ``attn_local`` layer, the recurrent state of an ``rwkv`` or ``rglru``
    layer. ``attn``'s dense KV cache comes with the dense sampler (its
    paged cache is ``attention.init_paged_cache``)."""
    check_kind(kind, CACHE_KINDS)
    if kind == "attn_local":
        return attn.init_cache(cfg, batch, length,
                               window=_window(kind, cfg), device=device)
    if kind == "rglru":
        return ssm.init_rglru_state(cfg, batch, device=device)
    return ssm.init_rwkv_state(cfg, batch, device=device)


def layer_prefill(kind, p, x, ctx, cfg, cache):
    """Prompt forward from the cache's state. ctx: positions (S,) (read by
    ``attn_local`` only). Returns (x, cache)."""
    check_kind(kind, CACHE_KINDS)
    if kind == "rwkv":
        return _rwkv(p, x, cfg, cache)
    if kind == "rglru":
        return _rglru(p, x, cfg, cache)
    h, cache = attn.attn_prefill(p.attn, norm_fwd(p.norm1, x, cfg),
                                 ctx["positions"], cfg, cache=cache,
                                 window=_window(kind, cfg))
    return _mlp_after(p, x, h, cfg), cache


def layer_decode(kind, p, x, t, cfg, cache):
    """Single-token step at position t. x (B,1,d). Returns (x, cache)."""
    check_kind(kind, CACHE_KINDS)
    if kind == "rwkv":
        return _rwkv(p, x, cfg, cache)
    if kind == "rglru":
        return _rglru(p, x, cfg, cache)
    h, cache = attn.attn_decode(p.attn, norm_fwd(p.norm1, x, cfg), t, cfg,
                                cache=cache)
    return _mlp_after(p, x, h, cfg), cache


def layer_paged_prefill(kind, p, x, ctx, cfg, cache):
    """Prompt forward for fresh rows, writing K/V into their pages.
    ctx: positions (S,), block_tables (B,maxp). Returns (x, cache)."""
    check_kind(kind)
    h, cache = attn.paged_attn_prefill(
        p.attn, norm_fwd(p.norm1, x, cfg), ctx["positions"], cfg,
        cache=cache, block_tables=ctx["block_tables"])
    return _mlp_after(p, x, h, cfg), cache


def layer_paged_decode(kind, p, x, ctx, cfg, cache):
    """Single-token step over the paged cache. x (B,1,d); ctx: positions
    (B,), block_tables (B,maxp), lengths (B,). Returns (x, cache)."""
    check_kind(kind)
    h, cache = attn.paged_attn_decode(
        p.attn, norm_fwd(p.norm1, x, cfg), ctx["positions"], cfg,
        cache=cache, block_tables=ctx["block_tables"],
        lengths=ctx["lengths"])
    return _mlp_after(p, x, h, cfg), cache
