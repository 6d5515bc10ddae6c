"""Decoder-only LM with an optional patch prefix (the ``vision_patches``
frontend of llava-next-34b, which the ProGen structure prefix also uses),
and the encoder-decoder (whisper-small's ``audio_frames`` frontend: the
frames run through the encoder once, each decoder layer cross-attends to
its output): forward, the training loss (``lm_loss``, with the MoE
router's aux terms), dense serving over each layer's decode cache
(recurrent states of ``rwkv`` and ``rglru`` layers, dense K/V caches of
``attn`` and ``moe`` layers, ring K/V caches of ``attn_local`` and
``attn_local_moe`` layers, self and cross caches of ``dec_attn`` layers)
and paged serving (``attn`` layers).

Batch dicts: {"inputs": (B,S) int tokens, "patches": (B,P,d) or "frames":
(B,F,d) where the frontend takes them, "targets": (B,S) int, -1 masked,
for ``lm_loss``}.

Serving:
  prefill(params, batch, cfg)  -> logits_last (B,V), caches, t_next
  decode_step(params, caches, token (B,1), t, cfg) -> logits (B,V), caches
"""

from __future__ import annotations

import contextlib

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import (Dense, Embedding, Norm, embed_tokens,
                                       gumbel_noise, head_fwd, head_input,
                                       logits_fwd, norm_fwd, torch_dtype,
                                       vocab_lo)
from repro_torch.models.moe import AUX_KEYS, local_experts

# the reference's lm_loss coefficients of the MoE load-balance and z losses
LB_COEF, Z_COEF = 0.01, 1e-4


class LM(nn.Module):
    """Embedding, layers, final norm and, unless the embedding is tied to
    it, the LM head; with ``cfg.encoder_segments`` also the encoder's
    layers (``enc_layers``) and its final norm (``enc_norm``). ``cfg``
    stays with the weights: the bridge, the checkpoints and the optimizer
    read the reference's layout from it."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        self.cfg = cfg
        self.embedding = Embedding(cfg, gen)
        self.final_norm = Norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = Dense((cfg.d_model, cfg.padded_vocab), cfg.d_model,
                                 torch_dtype(cfg.param_dtype), gen)
        self.layers = nn.ModuleList(blocks.Layer(kind, cfg, gen)
                                    for kind in cfg.layer_kinds)
        if cfg.encoder_segments:
            self.enc_layers = nn.ModuleList(blocks.Layer(kind, cfg, gen)
                                            for kind in cfg.encoder_kinds)
            self.enc_norm = Norm(cfg)


def init_lm(cfg, seed=0, device="cuda", mesh=None, mode="train") -> LM:
    """Seeded LM: fan-in scaled normal weights in the reference's shapes,
    drawn by a generator on ``device`` itself (the CUDA Philox stream on
    the card), so a full-width model is never built in host memory. The
    same seed gives other weights on the CPU than on the card. With
    ``mesh``, stored by ``mode``'s rules (``sharding.shard_module``), each
    rank drawing the same weights and keeping its shard; the MoE experts
    are drawn keeping only the rank's rows of the expert axis
    (``moe.local_experts``, ``sharding.expert_rows``), so no rank holds
    every expert."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    rows = None if mesh is None else sharding.expert_rows(mesh, cfg, mode)
    with dev, local_experts(rows):
        params = LM(cfg, gen)
    if mesh is not None:
        sharding.shard_module(params, mesh, cfg, mode)
    return params


def _encode(params, frames, cfg):
    """The encoder over the frame embeddings (B,F,d): its layers, with RoPE
    over the frame positions (the reference's stand-in for whisper's
    learned positions), then its norm. Returns (B,F,d) in the compute
    dtype."""
    x = frames.to(torch_dtype(cfg.compute_dtype))
    ctx = {"positions": torch.arange(x.shape[1], device=x.device)}
    for layer, kind in zip(params.enc_layers, cfg.encoder_kinds):
        x, _ = blocks.layer_fwd_remat(kind, layer, x, ctx, cfg)
    return norm_fwd(params.enc_norm, x, cfg)


def _seq_split(batch, cfg):
    """Whether a full-sequence forward of ``batch`` splits the residual
    stream over ``model`` (``sharding.seq_split`` of its positions, the
    patch prefix counted, as the reference constrains after the
    concatenation); never with ``rwkv`` or ``rglru`` layers, whose scans
    take the whole sequence (no config asks for it there)."""
    S = prefix_len(batch, cfg) + batch["inputs"].shape[1]
    return sharding.seq_split(S, cfg) and not any(
        k in ("rwkv", "rglru") for k in cfg.layer_kinds)


def _context(params, batch, cfg, sp=False):
    """Token embeddings (patches prepended where the frontend takes them)
    and the layers' context: positions, and the encoder's output where
    there is an encoder. With ``sp`` (``_seq_split``) x is the rank's
    chunk of the sequence, positions the whole sequence's, and ctx["sp"]
    tells the layers. Returns (x, ctx, n_prefix)."""
    x, positions, n_prefix = _prefix_embed(params, batch, cfg, sp)
    ctx = {"positions": positions, "sp": sp}
    if cfg.encoder_segments:
        ctx["enc_out"] = _encode(params, batch["frames"], cfg)
    return x, ctx, n_prefix


def prefix_len(batch, cfg):
    """The length of the patch prefix that the batch's tokens follow: the
    cache slots it takes before them (0 without one)."""
    if cfg.frontend == "vision_patches" and "patches" in batch:
        return batch["patches"].shape[1]
    return 0


def _prefix_embed(params, batch, cfg, sp=False):
    """Token embeddings, with patches prepended when present (with ``sp``
    the rank's chunk of them, ``common.embed_tokens``). Returns (x,
    positions of the whole sequence, n_prefix)."""
    n_prefix = prefix_len(batch, cfg)
    x = embed_tokens(params.embedding, batch["inputs"], cfg,
                     batch["patches"] if n_prefix else None, sp)
    S = n_prefix + batch["inputs"].shape[1]
    positions = torch.arange(S, device=x.device)
    return x, positions, n_prefix


def _trunk(params, batch, cfg):
    """The embedding and the layers: (x, aux, n_prefix, sp), x the rank's
    chunk of the sequence where ``sp`` (``_seq_split``), else all of it,
    patch prefix included."""
    sp = _seq_split(batch, cfg)
    x, ctx, n_prefix = _context(params, batch, cfg, sp)
    auxs = {k: torch.zeros((), device=x.device) for k in AUX_KEYS}
    for layer, kind in zip(params.layers, cfg.layer_kinds):
        x, aux = blocks.layer_fwd_remat(kind, layer, x, ctx, cfg)
        for k, v in aux.items():
            auxs[k] = auxs[k] + v
    return x, auxs, n_prefix, sp


def lm_hidden(params, batch, cfg):
    """Backbone forward -> (hidden (B,S,d) at the token positions, aux),
    each layer rematerialized in training as ``cfg.remat`` says
    (``blocks.layer_fwd_remat``):
    ``moe.AUX_KEYS``' values summed over the layers, fp32 zeros where a
    layer has no experts (so a dense config reports zeros, as the
    reference's segment scan pads them). In a train step that splits the
    residual stream over ``model`` (``_seq_split``) the layers compute on
    the rank's chunk of the sequence and the chunks are gathered here
    (``gather_from_model``: the layers after it compute alike on every
    rank); ``lm_loss`` gathers after the final norm instead."""
    x, auxs, n_prefix, sp = _trunk(params, batch, cfg)
    if sp:
        x = sharding.gather_from_model(x, 1)
    return x[:, n_prefix:], auxs


def lm_logits(params, batch, cfg):
    """Full-sequence forward -> logits (B,S,padded_vocab) (the router's
    aux values are ``lm_hidden``'s)."""
    return logits_fwd(params, lm_hidden(params, batch, cfg)[0], cfg)


def _ce_sums(lf, targets, lo=None):
    """(CE summed over the valid (target >= 0) positions, their count) of
    fp32 logits ``lf``. With ``lo`` they are this rank's vocab entries from
    ``lo`` on (a tensor-parallel step, ``common.vocab_lo``): the max is
    taken over ``model`` (no gradient), the sum of exponentials and the
    gold logit, which only the rank that holds it contributes, are summed
    over ``model``."""
    ids = targets.clamp_min(0).long()
    if lo is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, ids[..., None])[..., 0]
    else:
        m = sharding.max_over_model(lf.detach().amax(-1))
        lse = torch.log(sharding.reduce_from_model(
            torch.exp(lf - m[..., None]).sum(-1))) + m
        ids = ids - lo
        own = (ids >= 0) & (ids < lf.shape[-1])
        gold = lf.gather(-1, ids.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
        gold = sharding.reduce_from_model(
            torch.where(own, gold, torch.zeros_like(gold)))
    valid = (targets >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def cross_entropy(logits, targets, lo=None):
    """Mean CE over valid (target >= 0) positions, computed in fp32;
    ``lo`` as ``_ce_sums`` takes it."""
    total, count = _ce_sums(logits.float(), targets, lo)
    return total / count.clamp_min(1.0)


def _chunked_ce(params, x, targets, cfg, logits=logits_fwd):
    """Sequence-chunked logits + CE: peak memory is one chunk of
    (tokens / chunks, padded_vocab) fp32 logits instead of the whole
    sequence's (of this rank's vocab entries in a tensor-parallel step).
    Each chunk's logits (``logits(params, chunk, cfg)``; the final norm and
    the head by default) are recomputed in the backward pass."""
    n = cfg.ce_chunks
    S = x.shape[1]
    if S % n:
        raise ValueError(f"{S} positions in {n} CE chunks")
    c = S // n
    lo = vocab_lo(params, cfg)

    def body(xi, ti):
        return _ce_sums(logits(params, xi, cfg).float(), ti, lo)

    total = count = 0.0
    for i in range(n):
        s, v = torch.utils.checkpoint.checkpoint(
            body, x[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c],
            use_reentrant=False, context_fn=lambda: (
                contextlib.nullcontext(), blocks.carried_contexts()))
        total, count = total + s, count + v
    return total / torch.clamp(count, min=1.0)


def lm_loss(params, batch, cfg):
    """Next-token CE of ``batch["targets"]`` (-1 masks a position) over the
    forward of ``batch["inputs"]``, plus ``LB_COEF`` x the MoE load-balance
    loss and ``Z_COEF`` x the router z-loss (summed over the layers; zeros
    without experts); returns (loss, metrics): ``ce_loss``, the three aux
    values (``moe.AUX_KEYS``) and ``loss``. Where the residual stream is
    split over ``model`` (``_seq_split``) the final norm runs on the
    rank's chunk and the chunks are gathered before the head
    (``common.head_input``); the CE's chunks and vocab split are as
    without."""
    x, aux, n_prefix, sp = _trunk(params, batch, cfg)
    logits = logits_fwd
    if sp:
        x, logits = head_input(params, x, cfg, sp=True), head_fwd
    x = x[:, n_prefix:]
    if cfg.ce_chunks > 1:
        ce = _chunked_ce(params, x, batch["targets"], cfg, logits)
    else:
        ce = cross_entropy(logits(params, x, cfg), batch["targets"],
                           vocab_lo(params, cfg))
    loss = ce + LB_COEF * aux["moe_lb_loss"] + Z_COEF * aux["moe_z_loss"]
    return loss, {"ce_loss": ce, **aux, "loss": loss}


def init_caches(cfg, batch, length, device=None, mesh=None):
    """One decode cache per layer (``blocks.init_layer_cache``); ``length``
    sizes the K/V caches of ``attn`` and ``attn_local`` layers. With
    ``mesh``, each the rank's shard as ``sharding.cache_spec_tree`` places
    it (``batch`` the rank's rows)."""
    return [blocks.init_layer_cache(kind, cfg, batch, length, device=device,
                                    mesh=mesh)
            for kind in cfg.layer_kinds]


def prefill(params, batch, cfg, cache_len: int = 0):
    """Run the prompt from fresh caches (an encoder's frames first, once);
    returns (last-position logits (B,V), caches, t_next). In a
    tensor-parallel step (``sharding.tp``) the caches are the rank's
    shards and the logits its vocab entries (``common.vocab_lo``)."""
    x, ctx, _ = _context(params, batch, cfg)
    S = x.shape[1]
    caches = init_caches(cfg, x.shape[0], max(cache_len, S), device=x.device,
                         mesh=sharding.tp().mesh)
    new_caches = []
    for layer, kind, cache in zip(params.layers, cfg.layer_kinds, caches):
        x, cache = blocks.layer_prefill(kind, layer, x, ctx, cfg, cache)
        new_caches.append(cache)
    return logits_fwd(params, x[:, -1:], cfg)[:, 0], new_caches, S


def decode_step(params, caches, token, t, cfg):
    """token (B,1) int; t the position it takes. Returns (logits (B,V),
    caches); in a tensor-parallel step as ``prefill`` gives them."""
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
    ``gen`` (a ``torch.Generator`` on the logits' device). The default
    ``cache_len`` holds the prompt, any patch prefix and the steps.
    Returns the tokens (B, steps)."""
    logits, caches, t = prefill(
        params, batch, cfg,
        cache_len=cache_len or (prefix_len(batch, cfg)
                                + batch["inputs"].shape[1] + steps))
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
