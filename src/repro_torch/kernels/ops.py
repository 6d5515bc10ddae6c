"""Dispatchers from model layout to the kernels' layouts.

Model code calls these with model-layout tensors; each converts to the
kernel layout and calls the kernel wrapper, which takes the plain version
for a CPU tensor and launches the CUDA kernel for a CUDA tensor (or
raises). ``flash_attention``, ``wkv6`` and ``rglru`` go through their
kernel's autograd Function (``flash_attention_grad``, ``wkv6_grad``,
``rglru_grad``) only when grad mode is on and an input requires grad, as
in a finetune or train step; every serving call takes the wrapper
directly. ``launches`` holds one plain-integer launch count per kernel,
``forms`` the flash and wkv6 kernels' counts split by form (each one's
gradient kernel is its ``backward`` form), ``by_namespace`` the counts
split by param-set namespace.

The kernels read raw pointers, so each dispatcher raises on a DTensor
(``distributed.sharding``): a sharded parameter is gathered by the layer
before it reaches attention or a scan, and a DTensor here is a fault, never
unwrapped to its local shard.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import rwkv6 as _wk
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels._cuda import (  # noqa: F401
    by_namespace, forms, launches, reset_launches, tally)


def _local_only(name, *xs):
    if any(is_dtensor(x) for x in xs):
        raise TypeError(f"{name}: a DTensor reached a kernel; gather it "
                        f"first (models.common.cast)")


def _training(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    seq_k=None, q_offset=0):
    """Model layout: q (B,S,H,hd); k/v (B,T,KV,hd). Returns (B,S,H,hd).
    One query (S == 1) hands the decode form k/v as strided (B,KV,T,hd)
    views of their own storage, so a ring cache is read in place and in its
    stored dtype; longer queries hand contiguous copies. ``seq_k``: only the
    first seq_k keys are live (None: all T). ``q_offset``: the position of
    query 0 among the keys (a context-parallel rank's chunk). With grad on
    and an input that requires it, the differentiable form runs (contiguous
    K/V)."""
    _local_only("flash_attention", q, k, v)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if q.shape[1] > 1:
        kt, vt = kt.contiguous(), vt.contiguous()
    fn = _fa.flash_attention_bhsd
    if _training(q, k, v):
        fn = _fa.flash_attention_grad
        kt, vt = kt.contiguous(), vt.contiguous()
    out = fn(q.transpose(1, 2).contiguous(), kt, vt, causal=causal,
             window=window, softcap=softcap, seq_k=seq_k, q_offset=q_offset)
    return out.transpose(1, 2)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           page_size):
    """Single-token decode over a paged KV cache.

    Model layout: q (B,1,H,hd); k/v_pages (P,KV,page_size,hd);
    block_tables (B,maxp) i32; lengths (B,) i32 valid entries per row
    (0 = inactive slot, output row is zero). Returns (B,1,H,hd)."""
    _local_only("paged_decode_attention", q, k_pages, v_pages, block_tables,
                lengths)
    B, _, H, hd = q.shape
    KV = k_pages.shape[1]
    qk = q[:, 0].reshape(B, KV, H // KV, hd).contiguous()  # h = kv*G + g
    out = _pa.paged_decode_bkgh(qk, k_pages, v_pages, block_tables, lengths,
                                page_size=page_size)
    return out.reshape(B, 1, H, hd)


def wkv6(r, k, v, logw, u, s0):
    """r/k/v/logw (B,H,T,K), any T >= 1; u (H,K); s0 (B,H,K,K).
    Returns y (B,H,T,K) in r's dtype, s_T (B,H,K,K) fp32."""
    _local_only("wkv6", r, k, v, logw, u, s0)
    args = (r, k, v, logw.float().contiguous(), u.float(),
            s0.float().contiguous())
    fn = _wk.wkv6_grad if _training(*args) else _wk.wkv6_bhtk
    return fn(*args)


def rglru(a, b, h0):
    """a/b (B,T,C), any T >= 1; h0 (B,C). Returns h (B,T,C) fp32, h_T (B,C)
    fp32."""
    _local_only("rglru", a, b, h0)
    args = (a.float().contiguous(), b.float().contiguous(),
            h0.float().contiguous())
    fn = _rg.rglru_grad if _training(*args) else _rg.rglru_btc
    return fn(*args)
