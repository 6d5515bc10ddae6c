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
the CUDA kernel for CUDA tensors: the split-KV decode body shared with
flash's decode form (``csrc/decode_attention.cuh``) over a paged key
source (``csrc/paged_attention.cu``). Each (row, KV head) is cut into
``paged_decode_splits`` key ranges, a count taken from the grid's static
shapes and never from ``lengths``; ``paged_decode_split_ref`` repeats the
kernel's order of operations. Page ids and lengths are trusted: a page id
outside the pool reads out of bounds.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import cost
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa

NAME = "paged_decode_bkgh"
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def paged_decode_ref(q, k_pages, v_pages, block_tables, lengths, *,
                     page_size: int):
    """Plain version of ``paged_decode_bkgh``: one batched page gather and
    a masked fp32 softmax over every row at once. Keys past a row's length
    weigh nothing, whatever their pages hold."""
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
    v = v.masked_fill(~mask[:, :, 0, :, None], 0.0)
    out = torch.einsum("bkgt,bkth->bkgh", p, v) / l[..., None]
    return out.to(q.dtype)


def paged_decode_split_ref(q, k_pages, v_pages, block_tables, lengths, *,
                           page_size: int, n_split: int,
                           tile: int = fa.DECODE_TILE):
    """The kernel's order of operations in plain PyTorch: row b's n =
    min(lengths[b], maxp * page_size) keys cut into ``n_split`` contiguous
    ranges of ceil(n / n_split) (the last ones may be empty), each range
    walked in tiles of ``tile`` keys with a running fp32 max, sum and
    accumulator (q pre-scaled by 1/sqrt(hd)), then the ranges' partials
    rescaled to their common max and summed, or, with one range, its
    accumulator normalised directly. Keys past a range are never used. The
    same function as ``paged_decode_ref``; the tests hold one to the
    other."""
    B, KV, G, hd = q.shape
    maxp = block_tables.shape[1]
    qf = q.float() * (1.0 / math.sqrt(hd))
    n = lengths.long().clamp(0, maxp * page_size)
    per = (n + n_split - 1) // n_split
    bt = block_tables.long()
    rows = torch.arange(B, device=q.device)[:, None]
    cols = torch.arange(tile, device=q.device)[None, :]
    parts = []
    for split in range(n_split):
        lo = torch.minimum(n, split * per)
        hi = torch.minimum(n, lo + per)
        m = qf.new_full((B, KV, G), NEG_INF)
        l = qf.new_zeros(B, KV, G)
        acc = qf.new_zeros(B, KV, G, hd)
        for t0 in range(0, int((hi - lo).max()) if B else 0, tile):
            key = lo[:, None] + t0 + cols                    # (B, tile)
            live = key < hi[:, None]
            key = torch.where(live, key, 0)
            pages = bt[rows, key // page_size]
            # (B, tile, KV, hd) -> (B, KV, tile, hd)
            k = k_pages[pages, :, key % page_size].transpose(1, 2).float()
            v = v_pages[pages, :, key % page_size].transpose(1, 2).float()
            v = torch.where(live[:, None, :, None], v, 0.0)
            s = torch.einsum("bkgh,bkth->bkgt", qf, k)
            s = torch.where(live[:, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(live[:, None, None, :],
                            torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgt,bkth->bkgh",
                                                        p, v)
            m = m_new
        parts.append((m, l, acc))
    if n_split == 1:
        m, l, acc = parts[0]
        return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(torch.exp(m - mx) * li for m, li, _ in parts)
    acc = sum(torch.exp(m - mx)[..., None] * ai for m, _, ai in parts)
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


def paged_decode_splits(B: int, KV: int, G: int, maxp: int, page: int,
                        n_sms: int) -> int:
    """Key ranges the kernel cuts each (row, KV head) into, from the grid's
    static shapes alone (never the lengths, so a fixed engine launches a
    fixed grid, as a CUDA graph needs): the flash decode form's count
    (``flash_attention.decode_key_splits``) for a row capacity of maxp x
    page keys. 1 where the B x KV x ceil(G / 16) blocks already fill the
    card's ``n_sms`` SMs, or where the capacity holds fewer than 2 x
    ``flash_attention.MIN_SPLIT_TILES`` tiles of 32; otherwise as many
    ranges of at least that many tiles (128 keys) as fill the SMs, at most
    ``flash_attention.MAX_SPLITS``."""
    return fa.decode_key_splits(B * KV * -(-G // fa.DECODE_GROUP),
                                maxp * page, n_sms)


def paged_decode_bkgh(q, k_pages, v_pages, block_tables, lengths, *,
                      page_size: int):
    """q (B, KV, G, hd); k/v_pages (P, KV, page_size, hd); block_tables
    (B, maxp) i32; lengths (B,) i32. Returns (B, KV, G, hd) in q's dtype.
    Its cost (``distributed.cost.paged_work``) counts the live tokens, the
    sum of ``lengths``, or every slot of the block tables on ``meta``."""
    B, KV, G, hd = q.shape
    maxp = block_tables.shape[1]

    def work():
        live = B * maxp * page_size if lengths.is_meta \
            else int(lengths.sum())
        return cost.paged_work(B, KV, G, hd, live, maxp, q.element_size())
    with cost.counted("flashattn", work):
        if q.device.type == "meta":
            return torch.empty_like(q)
        if q.device.type == "cpu":
            return paged_decode_ref(q, k_pages, v_pages, block_tables,
                                    lengths, page_size=page_size)
        if q.device.type != "cuda":
            raise ValueError(f"{NAME}: no kernel for {q.device}")
        return _launch(q, k_pages, v_pages, block_tables, lengths, page_size)


def _launch(q, k_pages, v_pages, block_tables, lengths, page_size,
            n_split=None):
    """Check the inputs, then launch the kernel on the current stream.
    ``n_split`` overrides ``paged_decode_splits`` (the tests and the chip
    run force ranges with it)."""
    dev = _cuda.check_cuda_tensors(
        NAME, (q, k_pages, v_pages, block_tables, lengths),
        (fa.DTYPES, (q.dtype,), (q.dtype,), (torch.int32,), (torch.int32,)))
    if q.dim() != 4 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, block tables "
                         f"{tuple(block_tables.shape)}: want 4, 4, 2 dims")
    B, KV, G, hd = q.shape
    maxp = block_tables.shape[1]
    if (hd not in fa.HEAD_DIMS or k_pages.shape[1:] != (KV, page_size, hd)
            or v_pages.shape != k_pages.shape or KV == 0 or G == 0
            or block_tables.shape != (B, maxp) or lengths.shape != (B,)):
        raise ValueError(
            f"{NAME}: shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, block tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}, "
            f"page_size {page_size} (head dim must be one of {fa.HEAD_DIMS})")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{NAME}: the page pools must be 16-byte aligned")
    if n_split is None:
        n_split = paged_decode_splits(B, KV, G, maxp, page_size,
                                      _cuda.sm_count(dev))
    if not 1 <= n_split <= 65535:
        raise ValueError(f"{NAME}: n_split {n_split}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    part = torch.empty(B * KV * n_split * G * (hd + 2), dtype=torch.float32,
                       device=dev) if n_split > 1 else None
    err = _cuda.lib().repro_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, KV, G, hd, page_size,
        maxp, n_split, _cuda.DTYPE_CODES[q.dtype],
        *_cuda.device_and_stream(dev))
    _cuda.check_launch(NAME, err)
    return out
