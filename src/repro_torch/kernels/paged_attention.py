"""Single-token decode attention over a paged KV cache.

One query token per row attends to that row's K/V history, which lives in
fixed-size pages of a shared pool. A per-row block table maps logical page
index -> physical page id and a per-row length gives the number of valid
K/V entries; ``lengths[b] == 0`` marks an inactive slot whose output row is
exactly zero.

Layouts (head-major):
  q           (B, KV, G, hd)      one query token per row, grouped heads
  k/v_pages   (P, KV, page, hd)   shared page pool (P includes trash page)
  block_table (B, maxp) int32     physical page id per logical page
  lengths     (B,) int32          valid K/V entries per row (0 = inactive)

``paged_decode_bkgh`` takes the plain version for CPU tensors and launches
the CUDA kernel (``csrc/paged_attention.cu``) for CUDA tensors. Page ids
and lengths are trusted: a page id outside the pool reads out of bounds.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def paged_decode_ref(q, k_pages, v_pages, block_tables, lengths, *,
                     page_size: int):
    """Plain version of ``paged_decode_bkgh``: one batched page gather and
    a masked fp32 softmax over every row at once."""
    B, KV, G, hd = q.shape
    maxp = block_tables.shape[1]
    T = maxp * page_size
    bt = block_tables.long()
    # (B, maxp, KV, page, hd) -> (B, KV, maxp*page, hd)
    k = k_pages[bt].permute(0, 2, 1, 3, 4).reshape(B, KV, T, hd).float()
    v = v_pages[bt].permute(0, 2, 1, 3, 4).reshape(B, KV, T, hd).float()
    qf = q.float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgh,bkth->bkgt", qf, k)
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    l = p.sum(-1).clamp_min(1e-20)        # inactive rows: l=0 -> out=0
    out = torch.einsum("bkgt,bkth->bkgh", p, v) / l[..., None]
    return out.to(q.dtype)


def paged_decode_bkgh(q, k_pages, v_pages, block_tables, lengths, *,
                      page_size: int):
    """q (B, KV, G, hd); k/v_pages (P, KV, page_size, hd); block_tables
    (B, maxp) i32; lengths (B,) i32. Returns (B, KV, G, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, block_tables, lengths,
                                page_size=page_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_bkgh: no kernel for {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, lengths, page_size)


def _launch(q, k_pages, v_pages, block_tables, lengths, page_size):
    name = "paged_decode_bkgh"
    fdt = (torch.float32, torch.bfloat16)
    dev = _cuda.check_cuda_tensors(
        name, (q, k_pages, v_pages, block_tables, lengths),
        (fdt, (q.dtype,), (q.dtype,), (torch.int32,), (torch.int32,)))
    B, KV, G, hd = q.shape
    P, kv_, page, hd_ = k_pages.shape
    maxp = block_tables.shape[1]
    if (kv_, page, hd_) != (KV, page_size, hd) \
            or v_pages.shape != k_pages.shape \
            or block_tables.shape != (B, maxp) or lengths.shape != (B,):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, block tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}, "
            f"page_size {page_size}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _cuda.lib().repro_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, KV, G, hd, page_size, maxp, _cuda.DTYPE_CODES[q.dtype],
        *_cuda.device_and_stream(dev))
    _cuda.check_launch(name, err)
    return out
