"""Transformer and recurrent layers. The reference stacks each segment's
layers on a ``repeats`` axis and runs them with ``lax.scan``; the port keeps
one ``Layer`` module per layer in an ``nn.ModuleList`` walked by a Python
loop (``cfg.layer_kinds`` gives each layer's kind, ``cfg.encoder_kinds``
an encoder's). Six kinds are ported: the dense causal ``"attn"`` kind (the
protein models and the dense decoders, with its dense cache and its paged
decode path), the local-window ``"attn_local"`` kind (with its dense ring
cache), the ``"rwkv"`` kind (RWKV-6 time mix + channel mix, with its
recurrent state as the decode cache), the ``"rglru"`` kind (the Griffin
recurrent block, with its RG-LRU and conv state), the encoder's
bidirectional ``"enc_attn"`` kind (no decode cache) and the
encoder-decoder's ``"dec_attn"`` kind (causal self-attention, then
cross-attention over the encoder output, then the MLP; its cache is
``{"self": dense cache, "cross": the encoder's K/V}``). The ``"moe"`` and
``"attn_local_moe"`` kinds are ``"attn"`` and ``"attn_local"`` with the
mixture-of-experts FFN (``moe.Moe``) in place of the MLP: their
full-sequence forward hands the router's aux values to the caller, their
prefill and decode drop them, as the reference's do.

In a train step whose residual stream is split over ``model``
(``ctx["sp"]``, set by ``lm.lm_hidden`` from ``sharding.seq_split``) a
layer takes and returns the rank's ``(B, S / model, d)`` chunk: its norms
and residual adds run on the chunk (the norms' scales gathered with
``use="partial"``), and its attention, MLP and MoE gather what they need
(``sp`` of each). The ``rwkv`` and ``rglru`` kinds scan the whole
sequence: a model with them is never split (``lm._seq_split``).

``layer_fwd_remat`` is the training forward under the reference's
``_remat`` (``cfg.remat``): "full" keeps only the layer's input and runs
the layer again in the backward pass, "dots" keeps the matrix products'
outputs as well (the reference's ``dots_saveable``)."""

from __future__ import annotations

import contextlib

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.kernels import _cuda
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import Norm, norm_fwd
from repro_torch.models.mlp import Mlp, mlp_fwd
from repro_torch.models.moe import Moe, moe_fwd

MOE_KINDS = ("moe", "attn_local_moe")
KINDS = ("attn", "attn_local", "rwkv", "rglru", "enc_attn", "dec_attn") \
    + MOE_KINDS
PAGED_KINDS = ("attn",)          # kinds with a paged KV cache
# kinds with a dense decode cache (an encoder layer runs once, uncached)
CACHE_KINDS = ("attn", "attn_local", "rwkv", "rglru", "dec_attn") \
    + MOE_KINDS


def check_kind(kind, ported=PAGED_KINDS):
    if kind not in ported:
        raise ValueError(f"layer kind {kind!r} is not ported for this path "
                         f"(ported: {ported})")


def _window(kind, cfg):
    return cfg.attn_window if kind in ("attn_local", "attn_local_moe") \
        else 0


class Layer(nn.Module):
    """``attn`` / ``attn_local`` / ``enc_attn``: pre-norm self-attention +
    MLP; ``moe`` / ``attn_local_moe`` the same with the MoE FFN (``moe``)
    in place of the MLP. ``dec_attn``: the same with pre-norm
    (``norm_x``) cross-attention (``xattn``) between them. ``rglru``:
    pre-norm Griffin recurrent block (``rec``) + MLP. ``rwkv``: pre-norm
    time mix + channel mix, both in ``tm``."""

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
        if kind == "dec_attn":
            self.norm_x = Norm(cfg)
            self.xattn = attn.Attention(cfg, gen)
        if kind in MOE_KINDS:
            self.moe = Moe(cfg, gen)
        else:
            self.mlp = Mlp(cfg, gen)


def _rwkv(p, x, cfg, state):
    h, state = ssm.rwkv_timemix(p.tm, norm_fwd(p.norm1, x, cfg), state, cfg)
    x = x + h
    h, state = ssm.rwkv_channelmix(p.tm, norm_fwd(p.norm2, x, cfg), state,
                                   cfg)
    return x + h, state


def _ffn_after(p, x, h, cfg, sp=False):
    """Residual add of the mixer's output h, then the feed-forward half:
    the MLP, or the MoE FFN where the layer has one. Returns (x, the
    router's aux values, {} without experts); prefill and decode drop
    the aux values. ``sp``: x and h are the rank's chunk of the
    sequence."""
    x = x + h
    h = norm_fwd(p.norm2, x, cfg, _norm_use(sp))
    if hasattr(p, "moe"):
        y, aux = moe_fwd(p.moe, h, cfg, sp=sp)
        return x + y, aux
    return x + mlp_fwd(p.mlp, h, cfg, sp), {}


def _norm_use(sp):
    """A norm's scale use: each rank's own rows with ``sp``."""
    return "partial" if sp else "local"


def _rglru(p, x, cfg, state):
    h, state = ssm.rglru_block(p.rec, norm_fwd(p.norm1, x, cfg), state, cfg)
    return _ffn_after(p, x, h, cfg)[0], state


def layer_fwd(kind, p, x, ctx, cfg):
    """Full-sequence forward. ctx: positions (S,) of the whole sequence,
    enc_out (B,F,d) for ``dec_attn``, and optionally sp (x is the rank's
    chunk of the sequence). Returns (x, aux): the MoE kinds' router aux
    values (``moe.moe_fwd``'s), {} for the other kinds."""
    check_kind(kind, KINDS)
    if kind == "rwkv":
        return _rwkv(p, x, cfg, ssm.init_rwkv_state(cfg, x.shape[0],
                                                    device=x.device))[0], {}
    if kind == "rglru":
        return _rglru(p, x, cfg, ssm.init_rglru_state(
            cfg, x.shape[0], device=x.device))[0], {}
    sp = ctx.get("sp", False)
    use = _norm_use(sp)
    h = attn.attn_fwd(p.attn, norm_fwd(p.norm1, x, cfg, use),
                      ctx["positions"], cfg, causal=kind != "enc_attn",
                      window=_window(kind, cfg), sp=sp)
    if kind == "dec_attn":
        x = x + h
        h, _ = attn.cross_prefill(p.xattn, norm_fwd(p.norm_x, x, cfg, use),
                                  ctx["enc_out"], cfg, sp=sp)
    return _ffn_after(p, x, h, cfg, sp)


REMATS = ("none", "full", "dots")
# what the "dots" policy keeps: the outputs of the matrix products
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _within(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def carried_contexts():
    """The forward thread's state for a recompute on autograd's thread: its
    kernel launches count as the forward's (``_cuda.resume``) and its
    layers compute in the forward's tensor-parallel step
    (``sharding.resume``)."""
    return _within(_cuda.resume(_cuda.running()),
                   sharding.resume(sharding.running()))


def _remat_contexts(cfg):
    """(forward, recompute) contexts of one rematerialized layer; the
    recompute runs on autograd's thread (``carried_contexts``)."""
    carried = carried_contexts()
    if cfg.remat == "full":
        return contextlib.nullcontext(), carried
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    fwd, recompute = create_selective_checkpoint_contexts(_save_dots)
    return fwd, _within(recompute, carried)


def layer_fwd_remat(kind, p, x, ctx, cfg):
    """``layer_fwd`` as the reference trains it: with grad on and
    ``cfg.remat`` "full" or "dots", under ``torch.utils.checkpoint``; with
    grad off or remat "none", as it is. No layer draws random numbers, so
    the recompute needs no RNG state to give the same values."""
    if cfg.remat not in REMATS:
        raise ValueError(f"remat {cfg.remat!r} not in {REMATS}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer_fwd(kind, p, x, ctx, cfg)
    return torch.utils.checkpoint.checkpoint(
        layer_fwd, kind, p, x, ctx, cfg, use_reentrant=False,
        preserve_rng_state=False,
        context_fn=lambda: _remat_contexts(cfg))


def init_layer_cache(kind, cfg, batch, length, device=None, mesh=None):
    """The decode cache of one layer: the dense K/V cache of ``length``
    slots of an ``attn`` or ``moe`` layer (an ``attn`` layer's paged cache
    is ``attention.init_paged_cache``), the ring K/V cache of an
    ``attn_local`` or ``attn_local_moe`` layer, the recurrent state of an
    ``rwkv`` or ``rglru`` layer. A ``dec_attn`` layer starts from its
    dense self cache alone: its prefill adds the cross cache it builds
    from the encoder's output (the reference allocates a zeroed one here,
    which its prefill replaces). With ``mesh``, this rank's shard of it as
    ``sharding.cache_spec_tree`` places it, ``batch`` the rank's rows."""
    check_kind(kind, CACHE_KINDS)
    if mesh is not None:
        return sharding.local_cache(
            init_layer_cache(kind, cfg, batch, length, device="meta"), kind,
            mesh, cfg, batch, device)
    if kind not in ("rglru", "rwkv"):
        return attn.init_cache(cfg, batch, length,
                               window=_window(kind, cfg), device=device)
    if kind == "rglru":
        return ssm.init_rglru_state(cfg, batch, device=device)
    return ssm.init_rwkv_state(cfg, batch, device=device)


def layer_prefill(kind, p, x, ctx, cfg, cache):
    """Prompt forward from the cache's state (``init_layer_cache``'s).
    ctx: positions (S,) (read by the attention kinds only), and enc_out
    (B,F,d) for ``dec_attn``, whose cache comes back as {"self", "cross"}.
    Returns (x, cache)."""
    check_kind(kind, CACHE_KINDS)
    if kind == "rwkv":
        return _rwkv(p, x, cfg, cache)
    if kind == "rglru":
        return _rglru(p, x, cfg, cache)
    h, self_cache = attn.attn_prefill(p.attn, norm_fwd(p.norm1, x, cfg),
                                      ctx["positions"], cfg, cache=cache,
                                      window=_window(kind, cfg))
    if kind != "dec_attn":
        return _ffn_after(p, x, h, cfg)[0], self_cache
    x = x + h
    h, cross = attn.cross_prefill(p.xattn, norm_fwd(p.norm_x, x, cfg),
                                  ctx["enc_out"], cfg, cached=True)
    return _ffn_after(p, x, h, cfg)[0], {"self": self_cache, "cross": cross}


def layer_decode(kind, p, x, t, cfg, cache):
    """Single-token step at position t. x (B,1,d). Returns (x, cache)."""
    check_kind(kind, CACHE_KINDS)
    if kind == "rwkv":
        return _rwkv(p, x, cfg, cache)
    if kind == "rglru":
        return _rglru(p, x, cfg, cache)
    self_cache = cache["self"] if kind == "dec_attn" else cache
    h, self_cache = attn.attn_decode(p.attn, norm_fwd(p.norm1, x, cfg), t,
                                     cfg, cache=self_cache)
    if kind != "dec_attn":
        return _ffn_after(p, x, h, cfg)[0], self_cache
    x = x + h
    h, _ = attn.attn_decode(p.xattn, norm_fwd(p.norm_x, x, cfg), t, cfg,
                            cache=cache["cross"], cross=True)
    return _ffn_after(p, x, h, cfg)[0], {"self": self_cache,
                                         "cross": cache["cross"]}


def layer_paged_prefill(kind, p, x, ctx, cfg, cache):
    """Prompt forward for fresh rows, writing K/V into their pages.
    ctx: positions (S,), block_tables (B,maxp). Returns (x, cache)."""
    check_kind(kind)
    h, cache = attn.paged_attn_prefill(
        p.attn, norm_fwd(p.norm1, x, cfg), ctx["positions"], cfg,
        cache=cache, block_tables=ctx["block_tables"])
    return _ffn_after(p, x, h, cfg)[0], cache


def layer_paged_decode(kind, p, x, ctx, cfg, cache):
    """Single-token step over the paged cache. x (B,1,d); ctx: positions
    (B,), block_tables (B,maxp), lengths (B,). Returns (x, cache)."""
    check_kind(kind)
    h, cache = attn.paged_attn_decode(
        p.attn, norm_fwd(p.norm1, x, cfg), ctx["positions"], cfg,
        cache=cache, block_tables=ctx["block_tables"],
        lengths=ctx["lengths"])
    return _ffn_after(p, x, h, cfg)[0], cache
