"""Blocked online-softmax (flash) attention forward.

``flash_attention_bhsd`` takes the plain version (``attention_ref``) for CPU
tensors and launches a CUDA kernel for CUDA tensors, chosen by shape and
dtype: one query (Sq == 1) goes to the split-KV decode kernel
(``csrc/flash_decode.cu``), which reads K/V in place through their strides
and in their stored dtype; longer fp32 queries to the register-tiled kernel
and bf16 ones to the ``mma.sync`` tensor-core kernel (both
``csrc/flash_attention.cu``; ``attention_tiled_ref`` repeats the latter's
algebra).
Contract, shared by all: q (B,H,Sq,hd), k/v (B,KV,Sk,hd) with GQA kv head =
h // (H // KV); scale 1/sqrt(hd); optional causal mask, local ``window``
and tanh ``softcap``; ``seq_q``/``seq_k`` (default Sq/Sk) mask rows and
columns past the real lengths; a q row with no live key writes zeros. K/V
have q's dtype, or are bf16 beside an fp32 q (the ring cache beside
recurrentgemma's fp32 queries), promoted exactly as the products promote
them. Unlike the TPU kernel, no input needs padding to a block multiple: the
kernels mask their ragged edges themselves.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda

NAME = "flash_attention_bhsd"
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernels' compiled head dims
DTYPES = (torch.float32, torch.bfloat16)
DECODE_GROUP = 16    # query rows a decode block holds
DECODE_TILE = 32     # keys a tile of a decode block
DECODE_STAGES = 3    # tiles in a decode block's shared-memory ring
MMA_ROWS = 64        # (query, head) rows a block of the bf16 sequence kernel
MMA_KEYS = 32        # keys a tile of the bf16 sequence kernel
MAX_SPLITS = 64      # key ranges a decode (row, KV head) is cut into, at most


def _scores(q, k, causal, window, softcap, seq_q, seq_k):
    """Masked fp32 scores (B,H,Sq,Sk), NEG_INF where masked, and the mask
    (Sq,Sk)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    seq_q = Sq if seq_q is None else seq_q
    seq_k = Sk if seq_k is None else seq_k
    kf = k.float().repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (1.0 / math.sqrt(hd))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = (rows < seq_q) & (cols < seq_k)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    return s.masked_fill(~mask, NEG_INF), mask


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  seq_q=None, seq_k=None):
    """Plain version of ``flash_attention_bhsd``: one masked fp32 softmax
    over the whole score matrix."""
    s, mask = _scores(q, k, causal, window, softcap, seq_q, seq_k)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    return (torch.einsum("bhqk,bhkd->bhqd", p, vf) / l).to(q.dtype)


def attention_split_ref(q, k, v, n_split, *, causal=True, window=0,
                        softcap=0.0, seq_q=None, seq_k=None):
    """The decode kernel's split-and-combine algebra in plain PyTorch, for
    any Sq: the keys cut into ``n_split`` contiguous ranges of
    ceil(Sk / n_split) (the last ones may be empty), a partial (m, l, acc)
    per range, then the partials rescaled to their common max and summed.
    The same function as ``attention_ref``; the tests hold one to the
    other."""
    s, mask = _scores(q, k, causal, window, softcap, seq_q, seq_k)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    Sk = k.shape[2]
    per = -(-Sk // n_split) if Sk else 0
    parts = []
    for i in range(n_split):
        lo, hi = min(Sk, i * per), min(Sk, (i + 1) * per)
        si = s[..., lo:hi]
        m = si.amax(-1, keepdim=True) if hi > lo else \
            s.new_full((*s.shape[:-1], 1), NEG_INF)
        p = torch.exp(si - m) * mask[:, lo:hi]
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhqk,bhkd->bhqd", p, vf[..., lo:hi, :])))
    m = torch.stack([mi for mi, _, _ in parts]).amax(0)
    l = sum(torch.exp(mi - m) * li for mi, li, _ in parts)
    acc = sum(torch.exp(mi - m) * ai for mi, _, ai in parts)
    return (acc / l.clamp_min(1e-20)).to(q.dtype)


def mma_smem_bytes(hd):
    """Dynamic shared memory of a bf16 sequence block: its rows of Q, then
    two stages of a K and a V tile, every row padded by 8 bf16."""
    return 2 * (MMA_ROWS + 4 * MMA_KEYS) * (hd + 8)


def decode_smem_bytes(hd, elem):
    """Dynamic shared memory of a block of the decode body
    (``csrc/decode_attention.cuh``, shared with paged decode) for K/V
    elements of ``elem`` bytes: the group's query rows in fp32, then the
    ring of K and V tiles, each K row padded by 16 bytes."""
    return DECODE_GROUP * hd * 4 + DECODE_STAGES * DECODE_TILE * (
        2 * hd + 16 // elem) * elem


def live_key_tiles(row_lo, row_hi, seq_q, seq_k, causal, window, bk):
    """The key tiles of ``bk`` keys that the sequence kernels load for a
    block of query positions ``row_lo..row_hi``: every tile that may hold a
    live key of a live row (``row < seq_q``), from the window's first key
    to ``seq_k``, or to the last row when causal. The others are skipped."""
    row_hi = min(row_hi, seq_q - 1)
    if row_hi < row_lo:
        return range(0)
    t_hi = -(-seq_k // bk)
    if causal:
        t_hi = min(t_hi, row_hi // bk + 1)
    t_lo = max(0, row_lo - window + 1) // bk if window > 0 else 0
    return range(t_lo, t_hi)


def attention_tiled_ref(q, k, v, bk=MMA_KEYS, *, causal=True, window=0,
                        softcap=0.0, seq_q=None, seq_k=None):
    """The bf16 sequence kernel's algebra in plain PyTorch. Rows are the
    (query, head) pairs of a KV head, row r = query r // G of head r % G,
    in blocks of ``MMA_ROWS``; each block walks ``live_key_tiles`` in tiles of
    ``bk`` keys (keys past ``seq_k`` read as zeros) with a running max and
    sum per row: fp32 scores scaled by 1/sqrt(hd), softcap, masks, then P
    rounded to bf16 before P.V, fp32 accumulation, the final divide with l
    floored at 1e-20. The same function as ``attention_ref`` up to P's
    rounding; the tests hold one to the other."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    seq_q = Sq if seq_q is None else seq_q
    seq_k = Sk if seq_k is None else seq_k
    scale = 1.0 / math.sqrt(hd)
    n_rows = G * Sq
    qr = q.float().reshape(B, KV, G, Sq, hd).transpose(2, 3) \
        .reshape(B, KV, n_rows, hd)
    kf, vf = k.float(), v.float()
    out = qr.new_zeros(B, KV, n_rows, hd)
    for r0 in range(0, n_rows, MMA_ROWS):
        rows = torch.arange(r0, min(r0 + MMA_ROWS, n_rows), device=q.device)
        pos = (rows // G)[:, None]
        m = qr.new_full((B, KV, len(rows), 1), NEG_INF)
        l = qr.new_zeros(B, KV, len(rows), 1)
        acc = qr.new_zeros(B, KV, len(rows), hd)
        for t in live_key_tiles(r0 // G, int(rows[-1]) // G, seq_q, seq_k,
                                causal, window, bk):
            cols = torch.arange(t * bk, (t + 1) * bk, device=q.device)
            held = cols < seq_k
            kt = kf.new_zeros(B, KV, bk, hd)
            vt = vf.new_zeros(B, KV, bk, hd)
            kt[:, :, held] = kf[:, :, cols[held]]
            vt[:, :, held] = vf[:, :, cols[held]]
            s = torch.einsum("bkrd,bkjd->bkrj", qr[:, :, rows], kt) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            live = (pos < seq_q) & held[None, :]
            if causal:
                live &= cols[None, :] <= pos
            if window > 0:
                live &= cols[None, :] > pos - window
            s = s.masked_fill(~live, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new) * live
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bkrj,bkjd->bkrd", p.to(torch.bfloat16).float(), vt)
            m = m_new
        out[:, :, r0:r0 + len(rows)] = acc / l.clamp_min(1e-20)
    return out.reshape(B, KV, Sq, G, hd).transpose(2, 3) \
        .reshape(B, H, Sq, hd).to(q.dtype)


def decode_splits(blocks: int, n_sms: int) -> int:
    """Key ranges the decode form cuts each (row, KV head) into: enough that
    ``blocks`` (B x KV x ceil(G / 16)) times it fills the card's ``n_sms``
    SMs, at most ``MAX_SPLITS``; ranges past the last key are empty. With
    1, the kernel writes the output itself and no combine runs."""
    return max(1, min(MAX_SPLITS, n_sms // max(1, blocks)))


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, softcap=0.0,
                         seq_q=None, seq_k=None):
    """q (B,H,Sq,hd); k/v (B,KV,Sk,hd). Returns (B,H,Sq,hd) in q's dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, seq_q=seq_q, seq_k=seq_k)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for {q.device}")
    seq_q, seq_k = _check(q, k, v, seq_q, seq_k)
    if q.shape[2] == 1:
        return _launch_decode(q, k, v, causal, softcap, seq_q, seq_k)
    return _launch_seq(q, k, v, causal, window, softcap, seq_q, seq_k)


def _check(q, k, v, seq_q, seq_k):
    """Dtypes and shapes every form takes; returns (seq_q, seq_k)."""
    if q.dtype not in DTYPES or k.dtype != v.dtype or not (
            k.dtype == q.dtype
            or (q.dtype == torch.float32 and k.dtype == torch.bfloat16)):
        raise TypeError(f"{NAME}: q {q.dtype}, k {k.dtype}, v {v.dtype} (K/V "
                        f"take q's dtype, or bf16 beside an fp32 q)")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    seq_q = Sq if seq_q is None else int(seq_q)
    seq_k = Sk if seq_k is None else int(seq_k)
    if (hd not in HEAD_DIMS or k.shape != (B, KV, Sk, hd)
            or v.shape != k.shape or KV == 0 or H % KV
            or not 0 <= seq_q <= Sq or not 0 <= seq_k <= Sk
            or B > 65535 or H > 65535):
        raise ValueError(
            f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, seq_q {seq_q}, seq_k {seq_k} (head dim must "
            f"be one of {HEAD_DIMS})")
    return seq_q, seq_k


def _launch_seq(q, k, v, causal, window, softcap, seq_q, seq_k):
    """Sq > 1: contiguous q, k, v; bf16 K/V beside an fp32 q are widened
    first (the fp32 kernel reads fp32)."""
    if k.dtype != q.dtype:
        k, v = k.float(), v.float()
    dev = _cuda.check_cuda_tensors(NAME, (q, k, v),
                                   (DTYPES, (q.dtype,), (q.dtype,)))
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _cuda.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, Sq, Sk, hd, seq_q, seq_k, int(bool(causal)), int(window),
        float(softcap), _cuda.DTYPE_CODES[q.dtype],
        *_cuda.device_and_stream(dev))
    _cuda.check_launch(NAME, err, "seq_f32" if q.dtype == torch.float32
                       else "seq_bf16")
    return out


def _launch_decode(q, k, v, causal, softcap, seq_q, seq_k, n_split=None):
    """Sq == 1: contiguous q; K/V strided views read in place. With one
    query at row 0 the masks leave the first ``n_keys`` keys live.
    ``n_split`` forces the number of key ranges (None: ``decode_splits``)."""
    dev = _cuda.check_cuda_tensors(NAME, (q,), (DTYPES,))
    _cuda.check_cuda_views(NAME, (k, v), ((k.dtype,), (k.dtype,)), dev)
    B, H, _, hd = q.shape
    KV = k.shape[1]
    n_keys = 0 if seq_q == 0 else min(1, seq_k) if causal else seq_k
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    G = H // KV
    if n_split is None:
        n_split = decode_splits(B * KV * -(-G // DECODE_GROUP),
                                _cuda.sm_count(dev))
    if not 1 <= n_split <= MAX_SPLITS:
        raise ValueError(f"{NAME}: {n_split} key ranges, not in "
                         f"[1, {MAX_SPLITS}]")
    part = torch.empty(B * KV * n_split * G * (hd + 2), dtype=torch.float32,
                       device=dev) if n_split > 1 else None
    err = _cuda.lib().repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, H, KV, hd, n_keys,
        *k.stride()[:3], *v.stride()[:3], n_split, float(softcap),
        _cuda.DTYPE_CODES[q.dtype], _cuda.DTYPE_CODES[k.dtype],
        *_cuda.device_and_stream(dev))
    _cuda.check_launch(NAME, err, "decode")
    return out
