"""Transformer layers. The reference stacks each segment's layers on a
``repeats`` axis and runs them with ``lax.scan``; the port keeps one
``Layer`` module per layer in an ``nn.ModuleList`` walked by a Python loop
(``cfg.layer_kinds`` gives each layer's kind). Only the dense causal
``"attn"`` kind is ported, the one the protein models and the paged decode
path use."""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import Norm, norm_fwd
from repro_torch.models.mlp import Mlp, mlp_fwd

PAGED_KINDS = ("attn",)


def check_kind(kind):
    if kind not in PAGED_KINDS:
        raise ValueError(f"layer kind {kind!r} is not ported "
                         f"(ported: {PAGED_KINDS})")


class Layer(nn.Module):
    """Pre-norm causal self-attention + SwiGLU MLP."""

    def __init__(self, kind, cfg, gen=None):
        super().__init__()
        check_kind(kind)
        self.norm1 = Norm(cfg)
        self.norm2 = Norm(cfg)
        self.attn = attn.Attention(cfg, gen)
        self.mlp = Mlp(cfg, gen)


def layer_fwd(kind, p, x, ctx, cfg):
    """Full-sequence forward. ctx: positions (S,). Returns x."""
    check_kind(kind)
    h = attn.attn_fwd(p.attn, norm_fwd(p.norm1, x, cfg), ctx["positions"],
                      cfg)
    x = x + h
    return x + mlp_fwd(p.mlp, norm_fwd(p.norm2, x, cfg), cfg)


def layer_paged_prefill(kind, p, x, ctx, cfg, cache):
    """Prompt forward for fresh rows, writing K/V into their pages.
    ctx: positions (S,), block_tables (B,maxp). Returns (x, cache)."""
    check_kind(kind)
    h, cache = attn.paged_attn_prefill(
        p.attn, norm_fwd(p.norm1, x, cfg), ctx["positions"], cfg,
        cache=cache, block_tables=ctx["block_tables"])
    x = x + h
    return x + mlp_fwd(p.mlp, norm_fwd(p.norm2, x, cfg), cfg), cache


def layer_paged_decode(kind, p, x, ctx, cfg, cache):
    """Single-token step over the paged cache. x (B,1,d); ctx: positions
    (B,), block_tables (B,maxp), lengths (B,). Returns (x, cache)."""
    check_kind(kind)
    h, cache = attn.paged_attn_decode(
        p.attn, norm_fwd(p.norm1, x, cfg), ctx["positions"], cfg,
        cache=cache, block_tables=ctx["block_tables"],
        lengths=ctx["lengths"])
    x = x + h
    return x + mlp_fwd(p.mlp, norm_fwd(p.norm2, x, cfg), cfg), cache
