"""Decoder-only LM with an optional patch prefix (the ``vision_patches``
frontend the ProGen structure prefix uses): forward, dense serving over
each layer's decode cache (recurrent states of ``rwkv`` and ``rglru``
layers, dense K/V caches of ``attn`` layers, ring K/V caches of
``attn_local`` layers) and paged serving (``attn`` layers).

Batch dicts: {"inputs": (B,S) int tokens, "patches": (B,P,d) optional}.

Serving:
  prefill(params, batch, cfg)  -> logits_last (B,V), caches, t_next
  decode_step(params, caches, token (B,1), t, cfg) -> logits (B,V), caches
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (Dense, Embedding, Norm, embed_tokens,
                                       gumbel_noise, logits_fwd, torch_dtype)


class LM(nn.Module):
    """Embedding, layers, final norm and, unless the embedding is tied to
    it, the LM head."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        self.embedding = Embedding(cfg, gen)
        self.final_norm = Norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = Dense((cfg.d_model, cfg.padded_vocab), cfg.d_model,
                                 torch_dtype(cfg.param_dtype), gen)
        self.layers = nn.ModuleList(blocks.Layer(kind, cfg, gen)
                                    for kind in cfg.layer_kinds)


def init_lm(cfg, seed=0, device="cuda") -> LM:
    """Seeded LM: fan-in scaled normal weights in the reference's shapes,
    drawn by a generator on ``device`` itself (the CUDA Philox stream on
    the card), so a full-width model is never built in host memory. The
    same seed gives other weights on the CPU than on the card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with dev:
        return LM(cfg, gen)


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


def init_caches(cfg, batch, length, device=None):
    """One decode cache per layer (``blocks.init_layer_cache``); ``length``
    sizes the K/V caches of ``attn`` and ``attn_local`` layers."""
    return [blocks.init_layer_cache(kind, cfg, batch, length, device=device)
            for kind in cfg.layer_kinds]


def prefill(params, batch, cfg, cache_len: int = 0):
    """Run the prompt from fresh caches; returns (last-position logits
    (B,V), caches, t_next)."""
    x, positions, _ = _prefix_embed(params, batch, cfg)
    S = x.shape[1]
    caches = init_caches(cfg, x.shape[0], max(cache_len, S), device=x.device)
    ctx = {"positions": positions}
    new_caches = []
    for layer, kind, cache in zip(params.layers, cfg.layer_kinds, caches):
        x, cache = blocks.layer_prefill(kind, layer, x, ctx, cfg, cache)
        new_caches.append(cache)
    return logits_fwd(params, x[:, -1:], cfg)[:, 0], new_caches, S


def decode_step(params, caches, token, t, cfg):
    """token (B,1) int; t the position it takes. Returns (logits (B,V),
    caches)."""
    x = embed_tokens(params.embedding, token, cfg)
    new_caches = []
    for layer, kind, cache in zip(params.layers, cfg.layer_kinds, caches):
        x, cache = blocks.layer_decode(kind, layer, x, t, cfg, cache)
        new_caches.append(cache)
    return logits_fwd(params, x, cfg)[:, 0], new_caches


def generate(params, batch, cfg, steps, cache_len=0, temperature=0.0,
             gen=None):
    """Greedy (``temperature <= 0``) or temperature sampling loop: one
    prefill, then ``steps - 1`` decode steps. Sampling takes
    ``argmax(logits / temperature + g)`` with Gumbel noise ``g`` from
    ``gen`` (a ``torch.Generator`` on the logits' device). Returns the
    tokens (B, steps)."""
    logits, caches, t = prefill(
        params, batch, cfg,
        cache_len=cache_len or (batch["inputs"].shape[1] + steps))
    tok = sample_tokens(logits, temperature, gen)
    toks = [tok]
    for i in range(1, steps):
        logits, caches = decode_step(params, caches, tok, t + i - 1, cfg)
        tok = sample_tokens(logits, temperature, gen)
        toks.append(tok)
    return torch.cat(toks, dim=1)


def sample_tokens(logits, temperature, gen=None):
    """logits (B,V) -> next tokens (B,1): argmax, or with ``temperature >
    0`` the Gumbel-max draw ``argmax(logits / temperature + g)`` (the form
    ``jax.random.categorical`` takes), ``g`` from ``gen``."""
    if temperature <= 0.0:
        return logits.argmax(-1)[:, None]
    g = gumbel_noise(gen, logits.shape, logits.device)
    return (logits.float() / temperature + g).argmax(-1)[:, None]


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
