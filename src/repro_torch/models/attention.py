"""GQA causal self-attention: full-sequence, paged prefill and paged decode.

Layouts: q proj (d, H, hd); k/v proj (d, KV, hd); o proj (H, hd, d).

The sequence mixing always goes through ``kernels.ops``: the flash kernel
for full sequences and prompts (the reference's ``attn_impl="pallas"``
branch; its prompt prefill uses a dense causal softmax, the same function)
and the paged decode kernel for one token. On CPU tensors those run their
plain versions.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.common import apply_rope, torch_dtype, weight


class Attention(nn.Module):
    def __init__(self, cfg, gen=None):
        super().__init__()
        if cfg.qk_norm:
            raise ValueError("qk_norm attention is not ported")
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = torch_dtype(cfg.param_dtype)
        self.wq = weight(gen, (d, H, hd), d, dt)
        self.wk = weight(gen, (d, KV, hd), d, dt)
        self.wv = weight(gen, (d, KV, hd), d, dt)
        self.wo = weight(gen, (H, hd, d), H * hd, dt)


def _qkv(p, x, positions, cfg):
    cdt = torch_dtype(cfg.compute_dtype)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(cdt))
    return apply_rope(q, positions, cfg), apply_rope(k, positions, cfg), v


def _proj_out(p, out, cfg):
    cdt = torch_dtype(cfg.compute_dtype)
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(cdt))


def attn_fwd(p, x, positions, cfg, *, causal=True, window=0):
    """Full-sequence self-attention through the flash kernel, which masks
    by index: ``positions`` (arange over the sequence) only feed RoPE.
    Returns (B,S,d)."""
    q, k, v = _qkv(p, x, positions, cfg)
    out = kops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cfg.attn_logit_softcap)
    return _proj_out(p, out, cfg)


def init_paged_cache(cfg, n_pages, page_size, dtype=None, device=None):
    """Paged cache for one attention layer: a shared pool of fixed-size K/V
    pages. ``n_pages`` includes any reserved trash page the caller points
    inactive rows at."""
    dt = dtype or torch_dtype(cfg.compute_dtype)
    shape = (n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
            "v_pages": torch.zeros(shape, dtype=dt, device=device)}


def _paged_write(cache, k, v, page_ids, slots):
    """Scatter new K/V into the pages, in place (the reference returns a
    new pool; updating the pool in place saves copying it every step).
    k/v (B,S,KV,hd); page_ids/slots (B,S). Duplicate (page, slot) targets
    only occur on the trash page (inactive rows); CUDA leaves their order
    undefined, which is harmless only because the trash page is never read
    (inactive rows have length 0)."""
    B, S, KV, hd = k.shape
    pid = page_ids.reshape(-1).long()
    sl = slots.reshape(-1).long()
    kp, vp = cache["k_pages"], cache["v_pages"]
    kp[pid, :, sl] = k.reshape(B * S, KV, hd).to(kp.dtype)
    vp[pid, :, sl] = v.reshape(B * S, KV, hd).to(vp.dtype)
    return cache


def paged_attn_prefill(p, x, positions, cfg, *, cache, block_tables):
    """Prompt attention for freshly admitted rows, writing K/V into the
    rows' pages. x (B,S,d); positions (S,) = arange(S); block_tables
    (B,maxp). Causal over the prompt itself (the pages hold nothing older),
    through the flash kernel. Returns (out (B,S,d), cache)."""
    q, k, v = _qkv(p, x, positions, cfg)
    page_size = cache["k_pages"].shape[2]
    page_ids = block_tables[:, (positions // page_size).long()]     # (B,S)
    slots = (positions % page_size)[None].expand_as(page_ids)
    cache = _paged_write(cache, k, v, page_ids, slots)
    out = kops.flash_attention(q, k, v, causal=True,
                               softcap=cfg.attn_logit_softcap)
    return _proj_out(p, out, cfg), cache


def paged_attn_decode(p, x, positions, cfg, *, cache, block_tables,
                      lengths):
    """One-token decode over the paged cache. x (B,1,d); positions (B,)
    per-row write position of the new token; lengths (B,) valid K/V count
    *including* the new token (0 = inactive slot: its block table points at
    the trash page, its output row is zero). Returns (out, cache)."""
    q, k, v = _qkv(p, x, positions[:, None], cfg)
    page_size = cache["k_pages"].shape[2]
    page_ids = torch.gather(block_tables, 1,
                            (positions // page_size)[:, None].long())
    cache = _paged_write(cache, k, v, page_ids,
                         (positions % page_size)[:, None])
    out = kops.paged_decode_attention(
        q, cache["k_pages"], cache["v_pages"], block_tables, lengths,
        page_size=page_size)
    return _proj_out(p, out, cfg), cache
