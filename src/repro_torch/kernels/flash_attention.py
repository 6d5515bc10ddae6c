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
h // (H // KV); scale 1/sqrt(hd); optional causal mask, local ``window`` and
tanh ``softcap``; ``seq_q``/``seq_k`` (default Sq/Sk) mask rows and columns
past the real lengths; ``q_offset`` (default 0) is the global position of query
row 0, which the causal and window masks compare with key positions 0..Sk-1 (a
rank's chunk of a context-parallel sequence: ``models.attention``), while
``seq_q`` counts local rows; a q row with no live key writes zeros. K/V have
q's dtype, or are bf16 beside an fp32 q (the ring cache beside recurrentgemma's
fp32 queries), promoted exactly as the products promote them. Unlike the TPU
kernel, no input needs padding to a block multiple: the kernels mask their
ragged edges themselves.

Training (``flash_attention_grad``, the ``FlashAttention`` autograd
Function): the forward is ``flash_attention_bhsd`` as it is (the kernel on
CUDA tensors, the plain version on CPU tensors); the backward is
``flash_attention_bwd_bhsd``, the reference's own backward
(``_flash_xla_bwd_inner``, ``repro/models/attention.py``): from (q, k, v, o)
each row's log-sum-exp over its live keys and ``delta = (dO . O).sum(-1)``,
then the probabilities recomputed key block by key block, in fp32, dq, dk,
dv cast back to the inputs' dtypes. On CPU tensors it is the plain version
(``attention_lse``, a blockwise pass over the keys, then ``attention_bwd``);
on CUDA tensors the gradient kernel (``csrc/flash_bwd.cu``: lse and delta,
then dK/dV a key tile a block, then dq a row tile a block; one launch
counted under the ``backward`` form), whose tiles and order of sums
``attention_bwd_tiled_ref`` repeats. The reference computes this backward
in XLA, outside any Pallas kernel; the kernel is the port's. With
``softcap > 0`` it raises, as the reference's chunked XLA path asserts.

Cost accounting (``distributed.cost``): each call reports
``cost.flash_work`` over its live keys (the backward
``cost.flash_bwd_work``) under the ``flashattn`` tag to an active counter,
whatever implements it, and on the ``meta`` device returns an empty output
of the right shape and dtype (the dry run's path).
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import cost
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
MIN_SPLIT_TILES = 4  # tiles a range holds, at least, when a row is cut
BWD_KEYS = 128       # keys a block of the plain backward's passes
BWD_BQ = 64          # (query, head) rows a tile of the gradient kernel
BWD_BK = 32          # keys a tile of the gradient kernel's dK/dV and dq
BWD_LSE_BK = 64      # keys a tile of its lse pass


def _mask(Sq, cols, causal, window, seq_q, seq_k, q_offset, device):
    """Live (query, key) pairs (Sq, len(cols)): local row r (live below
    ``seq_q``) at position r + ``q_offset`` against key index ``cols``
    (live below ``seq_k``)."""
    rows = torch.arange(Sq, device=device)[:, None]
    pos = rows + q_offset
    cols = cols[None, :]
    mask = (rows < seq_q) & (cols < seq_k)
    if causal:
        mask = mask & (cols <= pos)
    if window > 0:
        mask = mask & (cols > pos - window)
    return mask


def _scores(q, k, causal, window, softcap, seq_q, seq_k, q_offset=0):
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
    mask = _mask(Sq, torch.arange(Sk, device=q.device), causal, window,
                 seq_q, seq_k, q_offset, q.device)
    return s.masked_fill(~mask, NEG_INF), mask


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  seq_q=None, seq_k=None, q_offset=0):
    """Plain version of ``flash_attention_bhsd``: one masked fp32 softmax
    over the whole score matrix."""
    s, mask = _scores(q, k, causal, window, softcap, seq_q, seq_k, q_offset)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    return (torch.einsum("bhqk,bhkd->bhqd", p, vf) / l).to(q.dtype)


def attention_split_ref(q, k, v, n_split, *, causal=True, window=0,
                        softcap=0.0, seq_q=None, seq_k=None, q_offset=0):
    """The decode kernel's split-and-combine algebra in plain PyTorch, for
    any Sq: the keys cut into ``n_split`` contiguous ranges of
    ceil(Sk / n_split) (the last ones may be empty), a partial (m, l, acc)
    per range, then the partials rescaled to their common max and summed.
    The same function as ``attention_ref``; the tests hold one to the
    other."""
    s, mask = _scores(q, k, causal, window, softcap, seq_q, seq_k, q_offset)
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


def live_key_tiles(row_lo, row_hi, seq_q, seq_k, causal, window, bk,
                   q_offset=0):
    """The key tiles of ``bk`` keys that the sequence kernels load for a
    block of local query rows ``row_lo..row_hi`` (positions + ``q_offset``):
    every tile that may hold a live key of a live row (``row < seq_q``),
    from the window's first key to ``seq_k``, or to the last row's position
    when causal. The others are skipped."""
    row_hi = min(row_hi, seq_q - 1)
    if row_hi < row_lo:
        return range(0)
    t_hi = -(-seq_k // bk)
    if causal:
        t_hi = min(t_hi, (row_hi + q_offset) // bk + 1)
    t_lo = (max(0, row_lo + q_offset - window + 1) // bk if window > 0
            else 0)
    return range(t_lo, max(t_lo, t_hi))


def live_query_tiles(key_lo, key_hi, seq_q, seq_k, causal, window, bq,
                     q_offset=0, group=1):
    """``live_key_tiles`` transposed: the tiles of ``bq`` rows that the
    gradient kernel's dK/dV block for keys ``key_lo..key_hi`` walks, rows r
    = query r // ``group`` (the (query, head) rows of a KV head): every
    tile that may hold a live query row (position + ``q_offset``) for a
    key below ``seq_k``, from the first query the causal mask lets read
    ``key_lo`` to the last whose window reaches ``key_hi``. The others are
    skipped."""
    key_hi = min(key_hi, seq_k - 1)
    if key_hi < key_lo:
        return range(0)
    lo = max(0, key_lo - q_offset) if causal else 0
    hi = seq_q
    if window > 0:
        hi = min(hi, key_hi - q_offset + window)
    if hi <= lo:
        return range(0)
    return range(lo * group // bq, -(-hi * group // bq))


def attention_tiled_ref(q, k, v, bk=MMA_KEYS, *, causal=True, window=0,
                        softcap=0.0, seq_q=None, seq_k=None, q_offset=0):
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
        local = (rows // G)[:, None]
        pos = local + q_offset
        m = qr.new_full((B, KV, len(rows), 1), NEG_INF)
        l = qr.new_zeros(B, KV, len(rows), 1)
        acc = qr.new_zeros(B, KV, len(rows), hd)
        for t in live_key_tiles(r0 // G, int(rows[-1]) // G, seq_q, seq_k,
                                causal, window, bk, q_offset):
            cols = torch.arange(t * bk, (t + 1) * bk, device=q.device)
            held = cols < seq_k
            kt = kf.new_zeros(B, KV, bk, hd)
            vt = vf.new_zeros(B, KV, bk, hd)
            kt[:, :, held] = kf[:, :, cols[held]]
            vt[:, :, held] = vf[:, :, cols[held]]
            s = torch.einsum("bkrd,bkjd->bkrj", qr[:, :, rows], kt) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            live = (local < seq_q) & held[None, :]
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


def attention_bwd_tiled_ref(q, k, v, o, g, *, causal=True, window=0,
                            seq_k=None, q_offset=0):
    """The gradient kernel's algebra in plain PyTorch: dq, dk, dv of
    ``attention_ref`` (no softcap) at the output gradient ``g``, in the
    kernel's tiles and order. Rows are the (query, head) pairs of a KV
    head, row r = query r // G of head r % G, in tiles of ``BWD_BQ``; keys
    in tiles of ``BWD_BK`` (keys past Sk read as zeros); the scale folded
    into q. (a) Each row tile's lse by an online pass over its
    ``live_key_tiles`` of ``BWD_LSE_BK`` keys, and delta = (g .
    o).sum(-1). (b) Each key tile's dK and dV summed over the row tiles of
    ``live_query_tiles`` in order, all G heads' rows inside the tile. (c)
    Each row tile's dq summed over its live key tiles in order, times the
    scale. p = exp(s - lse) and ds = p (dp - delta) on live pairs, exact
    zeros elsewhere; all in fp32, each gradient cast to its input's
    dtype. The same function as
    ``attention_lse`` + ``attention_bwd``; the tests hold one to the
    other."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    seq_k = Sk if seq_k is None else seq_k
    scale = 1.0 / math.sqrt(hd)
    n_rows = G * Sq

    def rows_of(x):
        return x.float().reshape(B, KV, G, Sq, hd).transpose(2, 3) \
            .reshape(B, KV, n_rows, hd)
    qs, gr = rows_of(q) * scale, rows_of(g)
    delta = (gr * rows_of(o)).sum(-1)
    n_kt = -(-Sk // BWD_BK)
    kp = q.new_zeros(B, KV, -(-Sk // BWD_LSE_BK) * BWD_LSE_BK, hd,
                     dtype=torch.float32)
    vp = torch.zeros_like(kp)
    kp[:, :, :Sk], vp[:, :, :Sk] = k.float(), v.float()
    row_tiles = [torch.arange(r0, min(r0 + BWD_BQ, n_rows), device=q.device)
                 for r0 in range(0, n_rows, BWD_BQ)]

    def keys(t, bk=BWD_BK):
        cols = torch.arange(t * bk, (t + 1) * bk, device=q.device)
        return cols, kp[:, :, cols], vp[:, :, cols]

    def live(rows, cols):
        pos = (rows // G)[:, None] + q_offset
        ok = (cols < seq_k)[None, :].expand(len(rows), -1)
        if causal:
            ok = ok & (cols[None, :] <= pos)
        if window > 0:
            ok = ok & (cols[None, :] > pos - window)
        return ok

    def key_tiles(rows, bk=BWD_BK):
        return live_key_tiles(int(rows[0]) // G, int(rows[-1]) // G, Sq,
                              seq_k, causal, window, bk, q_offset)

    lse = qs.new_empty(B, KV, n_rows)
    for rows in row_tiles:                                        # (a)
        m = qs.new_full((B, KV, len(rows)), NEG_INF)
        l = torch.zeros_like(m)
        for t in key_tiles(rows, BWD_LSE_BK):
            cols, kt, _ = keys(t, BWD_LSE_BK)
            lv = live(rows, cols)
            s = torch.einsum("bkrd,bkjd->bkrj", qs[:, :, rows], kt)
            s = s.masked_fill(~lv, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            l = l * torch.exp(m - m_new) + torch.where(
                lv, torch.exp(s - m_new[..., None]), 0.0).sum(-1)
            m = m_new
        lse[:, :, rows] = m + torch.log(l.clamp_min(1e-20))

    def pair_grads(rows, cols, kt, vt):
        lv = live(rows, cols)
        s = torch.einsum("bkrd,bkjd->bkrj", qs[:, :, rows], kt)
        p = torch.where(lv, torch.exp(s - lse[:, :, rows, None]), 0.0)
        dp = torch.einsum("bkrd,bkjd->bkrj", gr[:, :, rows], vt)
        return p, torch.where(lv, p * (dp - delta[:, :, rows, None]), 0.0)

    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for t in range(n_kt):                                         # (b)
        cols, kt, vt = keys(t)
        for u in live_query_tiles(t * BWD_BK, (t + 1) * BWD_BK - 1, Sq,
                                  seq_k, causal, window, BWD_BQ, q_offset,
                                  G):
            rows = row_tiles[u]
            p, ds = pair_grads(rows, cols, kt, vt)
            dv[:, :, cols] += torch.einsum("bkrj,bkrd->bkjd", p,
                                           gr[:, :, rows])
            dk[:, :, cols] += torch.einsum("bkrj,bkrd->bkjd", ds,
                                           qs[:, :, rows])
    dq = torch.zeros_like(qs)
    for rows in row_tiles:                                        # (c)
        for t in key_tiles(rows):
            cols, kt, vt = keys(t)
            _, ds = pair_grads(rows, cols, kt, vt)
            dq[:, :, rows] += torch.einsum("bkrj,bkjd->bkrd", ds, kt)
    dq = (dq * scale).reshape(B, KV, Sq, G, hd).transpose(2, 3) \
        .reshape(B, H, Sq, hd)
    return (dq.to(q.dtype), dk[:, :, :Sk].to(k.dtype),
            dv[:, :, :Sk].to(v.dtype))


def decode_splits(blocks: int, n_sms: int) -> int:
    """Key ranges the decode form cuts each (row, KV head) into: enough that
    ``blocks`` (B x KV x ceil(G / 16)) times it fills the card's ``n_sms``
    SMs, at most ``MAX_SPLITS``; ranges past the last key are empty. With
    1, the kernel writes the output itself and no combine runs."""
    return max(1, min(MAX_SPLITS, n_sms // max(1, blocks)))


def decode_key_splits(blocks: int, capacity: int, n_sms: int) -> int:
    """Key ranges the decode form cuts each (row, KV head) into, from static
    shapes alone: ``decode_splits``, but at most one range per
    ``MIN_SPLIT_TILES`` tiles of 32 of the row's key ``capacity`` (the K/V
    views' length, never the live key count, so a fixed cache launches a
    fixed grid). A row that holds fewer than 2 x ``MIN_SPLIT_TILES`` tiles
    is one range: the combine's extra launch would cost more than the
    split saves."""
    tiles = -(-capacity // DECODE_TILE)
    return min(decode_splits(blocks, n_sms), max(1, tiles // MIN_SPLIT_TILES))


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, softcap=0.0,
                         seq_q=None, seq_k=None, q_offset=0):
    """q (B,H,Sq,hd); k/v (B,KV,Sk,hd). Returns (B,H,Sq,hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    q_offset = int(q_offset)
    work = lambda: cost.flash_work(                              # noqa: E731
        B, H, k.shape[1], Sq, k.shape[2] if seq_k is None else seq_k, hd,
        q.element_size(), k.element_size(), causal, window, q_offset)
    with cost.counted("flashattn", work):
        if q.device.type == "meta":
            return torch.empty_like(q)
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, seq_q=seq_q, seq_k=seq_k,
                                 q_offset=q_offset)
        if q.device.type != "cuda":
            raise ValueError(f"{NAME}: no kernel for {q.device}")
        seq_q, seq_k = _check(q, k, v, seq_q, seq_k, q_offset)
        if q.shape[2] == 1:
            if q_offset:
                return _launch_decode_at(q, k, v, causal, window, softcap,
                                         seq_q, seq_k, q_offset)
            return _launch_decode(q, k, v, causal, softcap, seq_q, seq_k)
        return _launch_seq(q, k, v, causal, window, softcap, seq_q, seq_k,
                           q_offset)


def _check(q, k, v, seq_q, seq_k, q_offset=0):
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
            or not 0 <= q_offset < 2 ** 30
            or B > 65535 or H > 65535):
        raise ValueError(
            f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, seq_q {seq_q}, seq_k {seq_k}, q_offset "
            f"{q_offset} (head dim must be one of {HEAD_DIMS})")
    return seq_q, seq_k


def _launch_seq(q, k, v, causal, window, softcap, seq_q, seq_k, q_offset=0):
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
        q_offset, float(softcap), _cuda.DTYPE_CODES[q.dtype],
        *_cuda.device_and_stream(dev))
    _cuda.check_launch(NAME, err, "seq_f32" if q.dtype == torch.float32
                       else "seq_bf16")
    return out


def _launch_decode(q, k, v, causal, softcap, seq_q, seq_k, n_split=None):
    """Sq == 1: contiguous q; K/V strided views read in place. With one
    query at row 0 the masks leave the first ``n_keys`` keys live.
    ``n_split`` forces the number of key ranges (None:
    ``decode_key_splits`` of the views' length)."""
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
        n_split = decode_key_splits(B * KV * -(-G // DECODE_GROUP),
                                    k.shape[2], _cuda.sm_count(dev))
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


def decode_keys(seq_k, causal, window, q_offset):
    """The live keys [lo, hi) of one query at position ``q_offset``:
    ``[max(0, p - window + 1), p]`` when causal, from the window's first key
    to ``seq_k`` when not, within ``[0, seq_k)`` (empty: lo == hi)."""
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    hi = min(seq_k, q_offset + 1) if causal else seq_k
    lo = min(lo, seq_k)
    return lo, max(lo, hi)


def _launch_decode_at(q, k, v, causal, window, softcap, seq_q, seq_k,
                      q_offset):
    """Sq == 1 at position ``q_offset`` > 0 (a context-parallel chunk of
    one query): the decode form over the key range that
    ``decode_keys`` leaves live, handed as views of K/V from its first key
    on, unmasked over their first ``hi - lo`` keys."""
    lo, hi = decode_keys(seq_k, causal, window, q_offset)
    if lo == k.shape[2]:            # no live key: any view, none of it live
        lo = hi = 0
    return _launch_decode(q, k[:, :, lo:], v[:, :, lo:], False, softcap,
                          seq_q, hi - lo)


# ---------------------------------------------------------------------------
# training: the gradient
# ---------------------------------------------------------------------------

def _block_mask(Sq, lo, hi, causal, window, seq_k, device, q_offset=0):
    """Live (query, key) pairs (Sq, hi - lo) of keys lo..hi-1, query row r
    at position r + ``q_offset``."""
    return _mask(Sq, torch.arange(lo, hi, device=device), causal, window,
                 Sq, seq_k, q_offset, device)


def _scaled_groups(q, KV):
    """q (B,H,Sq,hd) as fp32 (B, KV, G, Sq, hd) scaled by 1/sqrt(hd): the
    scale folded into the query, as the reference folds it."""
    B, H, Sq, hd = q.shape
    return (q.float() * (1.0 / math.sqrt(hd))).reshape(B, KV, H // KV, Sq,
                                                       hd)


def attention_lse(q, k, *, causal=True, window=0, seq_k=None, q_offset=0):
    """Each query row's log-sum-exp of its masked, scaled fp32 scores
    (B,H,Sq), by an online pass over key blocks of ``BWD_KEYS``: the
    reference's forward scan without the values. A row with no live key
    gets NEG_INF + log(1e-20), as the reference's does, so that its
    probabilities recompute to zero."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    seq_k = Sk if seq_k is None else seq_k
    qf = _scaled_groups(q, KV)
    m = qf.new_full(qf.shape[:-1], NEG_INF)
    l = torch.zeros_like(m)
    for lo in range(0, Sk, BWD_KEYS):
        hi = min(Sk, lo + BWD_KEYS)
        mask = _block_mask(Sq, lo, hi, causal, window, seq_k, q.device,
                           q_offset)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, k[:, :, lo:hi].float())
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]) * mask
        l = l * torch.exp(m - m_new) + p.sum(-1)
        m = m_new
    return (m + torch.log(l.clamp_min(1e-20))).reshape(B, H, Sq)


def attention_bwd(q, k, v, o, lse, g, *, causal=True, window=0,
                  seq_k=None, q_offset=0):
    """dq, dk, dv of ``attention_ref`` (no softcap) at the output gradient
    ``g``, by the reference's key-blocked recomputation from (q, k, v, o,
    lse): for each key block, p = exp(s - lse) over the live pairs, dv = p^T
    g, dp = g v^T, ds = p (dp - delta) with delta = (g . o).sum(-1), dk =
    ds^T q (the scale folded into q), dq += ds k; all in fp32, each gradient
    cast back to its input's dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    seq_k = Sk if seq_k is None else seq_k
    qf = _scaled_groups(q, KV)
    gf = g.float().reshape(qf.shape)
    delta = (gf * o.float().reshape(gf.shape)).sum(-1)
    lse = lse.reshape(delta.shape)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for lo in range(0, Sk, BWD_KEYS):
        hi = min(Sk, lo + BWD_KEYS)
        kc, vc = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        mask = _block_mask(Sq, lo, hi, causal, window, seq_k, q.device,
                           q_offset)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kc)
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - lse[..., None]) * mask
        dvs.append(torch.einsum("bkgqs,bkgqd->bksd", p, gf))
        dp = torch.einsum("bkgqd,bksd->bkgqs", gf, vc)
        ds = p * (dp - delta[..., None])
        dks.append(torch.einsum("bkgqs,bkgqd->bksd", ds, qf))
        dq = dq + torch.einsum("bkgqs,bksd->bkgqd", ds, kc)
    dq = (dq.reshape(B, H, Sq, hd) * (1.0 / math.sqrt(hd))).to(q.dtype)
    return (dq, torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def flash_attention_bwd_bhsd(q, k, v, o, g, *, causal=True, window=0,
                             seq_k=None, q_offset=0):
    """dq, dk, dv of ``flash_attention_bhsd`` (no softcap) at the output
    ``o`` and its gradient ``g`` (B,H,Sq,hd), K/V in q's dtype; each in its
    input's dtype. CPU tensors: the plain ``attention_lse`` +
    ``attention_bwd``; CUDA tensors: the gradient kernel, one launch counted
    under the ``backward`` form (three kernels: lse and delta, dK/dV, dq).
    Reports ``cost.flash_bwd_work`` under ``flashattn``."""
    B, H, Sq, hd = q.shape
    q_offset = int(q_offset)
    work = lambda: cost.flash_bwd_work(                          # noqa: E731
        B, H, k.shape[1], Sq, k.shape[2] if seq_k is None else seq_k, hd,
        q.element_size(), k.element_size(), causal, window, q_offset)
    with cost.counted("flashattn", work):
        if q.device.type == "meta":
            return torch.empty_like(q), torch.empty_like(k), \
                torch.empty_like(v)
        if q.device.type == "cpu":
            lse = attention_lse(q, k, causal=causal, window=window,
                                seq_k=seq_k, q_offset=q_offset)
            return attention_bwd(q, k, v, o, lse, g, causal=causal,
                                 window=window, seq_k=seq_k,
                                 q_offset=q_offset)
        if q.device.type != "cuda":
            raise ValueError(f"{NAME}: no gradient kernel for {q.device}")
        return _launch_bwd(q, k, v, o, g, causal, window, seq_k, q_offset)


def _launch_bwd(q, k, v, o, g, causal, window, seq_k, q_offset):
    """Contiguous, 16-byte aligned q, k, v, o, g of one dtype."""
    _, seq_k = _check(q, k, v, None, seq_k, q_offset)
    dt = (q.dtype,)
    dev = _cuda.check_cuda_tensors(NAME, (q, k, v, o, g),
                                   (DTYPES, dt, dt, dt, dt))
    if o.shape != q.shape or g.shape != q.shape or window < 0:
        raise ValueError(f"{NAME} backward: q {tuple(q.shape)}, o "
                         f"{tuple(o.shape)}, g {tuple(g.shape)}, window "
                         f"{window}")
    if any(x.data_ptr() % 16 for x in (q, k, v, o, g)):
        raise ValueError(f"{NAME} backward: the kernel reads rows in 16-byte "
                         f"pieces: every input must start 16-byte aligned")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0:
        return dq, dk, dv
    lse, delta = (torch.empty(B * H * Sq, dtype=torch.float32, device=dev)
                  for _ in range(2))
    err = _cuda.lib().repro_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), B, H, KV, Sq, Sk, hd, seq_k, int(bool(causal)),
        int(window), q_offset, _cuda.DTYPE_CODES[q.dtype],
        *_cuda.device_and_stream(dev))
    _cuda.check_launch(NAME, err, "backward")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention_bhsd`` with a gradient: the forward is the wrapper
    as it is (one kernel launch on CUDA tensors), the backward
    ``flash_attention_bwd_bhsd`` (on CUDA tensors one launch of the
    gradient kernel, handed fresh contiguous tensors: autograd's g is a
    transposed view; on CPU tensors the plain backward). Autograd runs a
    CUDA backward on a thread of its own; its launch counts where the
    forward's did (``_cuda.resume``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, seq_k, q_offset):
        o = flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                 seq_k=seq_k, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = dict(causal=causal, window=window, seq_k=seq_k,
                        q_offset=q_offset)
        ctx.running = _cuda.running()
        return o

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if saved[0].device.type == "cuda":
            saved = [_cuda.fresh(x) for x in saved]
            g = _cuda.fresh(g.to(saved[0].dtype))
        with _cuda.resume(ctx.running):
            dq, dk, dv = flash_attention_bwd_bhsd(*saved, g, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_grad(q, k, v, *, causal=True, window=0, softcap=0.0,
                         seq_k=None, q_offset=0):
    """``flash_attention_bhsd``'s contract, differentiable in q, k and v
    (K/V in q's dtype). Raises ``NotImplementedError`` with a softcap."""
    if softcap > 0:
        raise NotImplementedError(
            f"{NAME}: no gradient with softcap {softcap} (the reference's "
            f"chunked XLA backward has none either)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{NAME}: the gradient takes K/V in q's dtype, not "
                        f"q {q.dtype}, k {k.dtype}, v {v.dtype}")
    return FlashAttention.apply(q, k, v, bool(causal), int(window), seq_k,
                                int(q_offset))
