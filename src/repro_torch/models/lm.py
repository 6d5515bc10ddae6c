"""Decoder-only LM with an optional patch prefix (the ``vision_patches``
frontend the ProGen structure prefix uses): forward and paged serving.

Batch dicts: {"inputs": (B,S) int tokens, "patches": (B,P,d) optional}.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (Dense, Embedding, Norm, embed_tokens,
                                       logits_fwd, torch_dtype)


class LM(nn.Module):
    """Embedding, layers, final norm and (untied) LM head."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        self.embedding = Embedding(cfg, gen)
        self.final_norm = Norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = Dense((cfg.d_model, cfg.padded_vocab), cfg.d_model,
                                 torch_dtype(cfg.param_dtype), gen)
        self.layers = nn.ModuleList(blocks.Layer(kind, cfg, gen)
                                    for kind in cfg.layer_kinds)


def _prefix_embed(params, batch, cfg):
    """Token embeddings, with patches prepended when present.
    Returns (x, positions, n_prefix)."""
    x = embed_tokens(params.embedding, batch["inputs"], cfg)
    n_prefix = 0
    if cfg.frontend == "vision_patches" and "patches" in batch:
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions, n_prefix


def lm_hidden(params, batch, cfg):
    """Backbone forward -> hidden (B,S,d) at the token positions."""
    x, positions, n_prefix = _prefix_embed(params, batch, cfg)
    ctx = {"positions": positions}
    for layer, kind in zip(params.layers, cfg.layer_kinds):
        x = blocks.layer_fwd(kind, layer, x, ctx, cfg)
    return x[:, n_prefix:]


def lm_logits(params, batch, cfg):
    """Full-sequence forward -> logits (B,S,padded_vocab)."""
    return logits_fwd(params, lm_hidden(params, batch, cfg), cfg)


def init_paged_caches(cfg, n_pages, page_size, dtype=None, device=None):
    """One paged cache per layer. ``n_pages`` includes any reserved trash
    page. Only dense causal ``attn`` layers have a paged layout."""
    for kind in cfg.layer_kinds:
        blocks.check_kind(kind)
    return [attn.init_paged_cache(cfg, n_pages, page_size, dtype=dtype,
                                  device=device)
            for _ in cfg.layer_kinds]


def paged_prefill(params, batch, cfg, caches, block_tables):
    """Run fresh rows' prompts, writing K/V into their pages (mapped by
    ``block_tables`` (B,maxp)). Returns (last-position logits (B,V),
    caches); the caches are the caller's long-lived page pool."""
    x, positions, _ = _prefix_embed(params, batch, cfg)
    ctx = {"positions": positions, "block_tables": block_tables}
    new_caches = []
    for layer, kind, cache in zip(params.layers, cfg.layer_kinds, caches):
        x, cache = blocks.layer_paged_prefill(kind, layer, x, ctx, cfg, cache)
        new_caches.append(cache)
    return logits_fwd(params, x[:, -1:], cfg)[:, 0], new_caches


def paged_decode_step(params, caches, token, positions, block_tables,
                      lengths, cfg):
    """One decode step with per-row positions over paged caches.

    token (B,1) int; positions (B,) each row's write position (its current
    true length); lengths (B,) valid K/V count including the new token,
    0 marking an inactive slot (its logits are garbage and must be masked
    by the caller). Returns (logits (B,V), caches)."""
    x = embed_tokens(params.embedding, token, cfg)
    ctx = {"positions": positions, "block_tables": block_tables,
           "lengths": lengths}
    new_caches = []
    for layer, kind, cache in zip(params.layers, cfg.layer_kinds, caches):
        x, cache = blocks.layer_paged_decode(kind, layer, x, ctx, cfg, cache)
        new_caches.append(cache)
    return logits_fwd(params, x, cfg)[:, 0], new_caches
