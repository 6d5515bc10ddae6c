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
Function) follows the reference's custom VJP (``_flash_xla``,
``repro/models/attention.py``): its forward ``_flash_xla_fwd`` returns each
row's log-sum-exp as a residual, and its backward ``_flash_xla_bwd_inner``
reads it, with ``delta = (dO . O).sum(-1)``, and recomputes the
probabilities key block by key block in fp32, dq, dk, dv cast back to the
inputs' dtypes. On CUDA tensors the forward is the sequence kernel asked
for that lse (``return_lse``: both sequence kernels write m + log(l) per
row beside o), and the backward ``flash_attention_bwd_bhsd`` is the
gradient kernel (``csrc/flash_bwd.cu``: delta, then dK/dV a key tile a
block, then dq a row tile a block, the products on the tensor cores, bf16
``mma.sync`` or TF32 in three parts for fp32; one launch counted under the
``backward`` form), whose tiles, order of sums and roundings
``attention_bwd_tiled_ref`` repeats. On CPU tensors the forward is
``attention_ref`` and the backward the plain ``attention_lse``, a blockwise
pass over the keys, then ``attention_bwd``. The reference computes this
backward in XLA, outside any Pallas kernel; the kernel is the port's. With
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
BWD_HELD = 64        # keys a dK/dV block, (query, head) rows a dq block of
#                      the gradient kernel (4 warps x 16)
BWD_MAX_SEGS = 4     # blocks the gradient kernel cuts a tile's walk into
BWD_FILL = 512       # its dq blocks below which it cuts their walks too
BWD_WHOLE = 1 << 30  # a segment's tiles when a walk is not cut


def bwd_step(hd, dtype):
    """Rows a step of the gradient kernel's dK/dV blocks, and keys a step
    of its dq blocks, for head dim ``hd`` and the inputs' ``dtype``: in bf16
    64 at head dims up to 64, 32 at 128, 16 at 256; in fp32 (its products'
    TF32 halves take registers) 64 up to 32, 32 at 64, 16 from 128. Two
    stages of them beside the held tiles fit one SM."""
    small = 32 if dtype == torch.float32 else 64
    return 64 if hd <= small else 32 if hd <= 2 * small else 16


def bwd_segments(B, KV, Sq, Sk, seq_k, causal, window, q_offset, group,
                 step, fill=BWD_FILL):
    """How the gradient kernel cuts its walks into blocks of their own,
    whose fp32 sums are then added in order: (seg, nseg, qseg, qnseg), row
    tiles a dK/dV segment and segments a key tile at most, key tiles a dq
    segment and segments a row tile at most; the kernel takes them as they
    are. dK/dV: the most row tiles (of ``step`` rows) any key tile walks
    (``live_query_tiles``) in at most ``BWD_MAX_SEGS`` runs of at least 2,
    so that the tile with the most rows (causal: the first) is not one
    block's long walk. dq: only when its grid (tiles of ``BWD_HELD`` rows x
    KV x B) has under ``fill`` blocks, its longest ``live_key_tiles`` walk
    likewise, in at most ceil(``fill`` / blocks) runs. A walk in one
    segment is whole (its seg at least its length)."""
    most = max((len(live_query_tiles(k0, k0 + BWD_HELD - 1, Sq, seq_k,
                                     causal, window, step, q_offset, group))
                for k0 in range(0, Sk, BWD_HELD)), default=0)
    seg = max(2, -(-most // BWD_MAX_SEGS))
    nseg = max(1, -(-most // seg))
    n_rows = group * Sq
    blocks = -(-n_rows // BWD_HELD) * KV * B
    cut = min(BWD_MAX_SEGS, -(-fill // blocks)) if blocks else 1
    if cut <= 1:
        return seg, nseg, BWD_WHOLE, 1
    most = max(len(live_key_tiles(
        r0 // group, (min(r0 + BWD_HELD, n_rows) - 1) // group, Sq, seq_k,
        causal, window, step, q_offset)) for r0 in range(0, n_rows, BWD_HELD))
    qseg = max(2, -(-most // cut))
    qnseg = max(1, -(-most // qseg))
    return seg, nseg, qseg if qnseg > 1 else BWD_WHOLE, qnseg


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
                  seq_q=None, seq_k=None, q_offset=0, return_lse=False):
    """Plain version of ``flash_attention_bhsd``: one masked fp32 softmax
    over the whole score matrix. ``return_lse``: also each row's
    log-sum-exp m + log(l) (B,H,Sq) fp32, l floored at 1e-20 (NEG_INF +
    log(1e-20) on a row with no live key)."""
    s, mask = _scores(q, k, causal, window, softcap, seq_q, seq_k, q_offset)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    o = (torch.einsum("bhqk,bhkd->bhqd", p, vf) / l).to(q.dtype)
    return (o, (m + torch.log(l))[..., 0]) if return_lse else o


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
                        softcap=0.0, seq_q=None, seq_k=None, q_offset=0,
                        return_lse=False):
    """The bf16 sequence kernel's algebra in plain PyTorch. Rows are the
    (query, head) pairs of a KV head, row r = query r // G of head r % G,
    in blocks of ``MMA_ROWS``; each block walks ``live_key_tiles`` in tiles of
    ``bk`` keys (keys past ``seq_k`` read as zeros) with a running max and
    sum per row: fp32 scores scaled by 1/sqrt(hd), softcap, masks, then P
    rounded to bf16 before P.V, fp32 accumulation, the final divide with l
    floored at 1e-20. The same function as ``attention_ref`` up to P's
    rounding; the tests hold one to the other. ``return_lse``: also each
    row's m + log(l) (B,H,Sq) fp32, what the kernel writes for the
    gradient (the reference's ``_flash_xla_fwd`` residual)."""
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
    lse = qr.new_empty(B, KV, n_rows)
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
        lse[:, :, r0:r0 + len(rows)] = (m + torch.log(l.clamp_min(1e-20)))[
            ..., 0]
    out = out.reshape(B, KV, Sq, G, hd).transpose(2, 3) \
        .reshape(B, H, Sq, hd).to(q.dtype)
    if not return_lse:
        return out
    return out, lse.reshape(B, KV, Sq, G).transpose(2, 3).reshape(B, H, Sq)


def _tf32(x, rounded=True):
    """fp32 ``x`` to TF32's 10 explicit mantissa bits: to nearest, ties
    away from zero (``cvt.rna.tf32.f32``'s rounding, what the gradient
    kernel computes in two integer operations), or cut (``rounded=False``:
    how the tensor cores read a 32-bit operand)."""
    bits = x.view(torch.int32)
    return (((bits + 0x1000) if rounded else bits) & -0x2000).view(
        torch.float32)


def _mm_tf32x3(eq, a, b):
    """``einsum(eq, a, b)`` of fp32 operands as the gradient kernel's fp32
    form takes it on the tensor cores: each operand split into hi =
    tf32(x) and lo = x - hi, read to TF32 by cutting, the product lo.hi' +
    hi.lo' + hi.hi' summed in fp32 (lo.lo' dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def attention_bwd_tiled_ref(q, k, v, o, g, lse, *, causal=True, window=0,
                            seq_k=None, q_offset=0):
    """The gradient kernel's algebra in plain PyTorch: dq, dk, dv of
    ``attention_ref`` (no softcap) at the output ``o``, its log-sum-exp
    ``lse`` (B,H,Sq; the forward's, ``return_lse``) and the output gradient
    ``g``, in the kernel's tiles and order. Rows are the (query, head) pairs
    of a KV head, row r = query r // G of head r % G; keys past Sk read as
    zeros. delta = (g . o).sum(-1). (b) Each tile of ``BWD_HELD`` keys sums
    its dK and dV over the steps of ``bwd_step(hd, dtype)`` rows of
    ``live_query_tiles``, in order, all G heads' rows inside the tile. (c)
    Each tile of ``BWD_HELD`` rows sums its dq over its ``live_key_tiles``
    of ``bwd_step(hd, dtype)`` keys, in order. Both walks in the segments
    of ``bwd_segments``, whose sums are added in order. On a live pair s = (q . k)
    / sqrt(hd) in fp32 (the forward's scores), p = exp(s - lse), ds = p (dp
    - delta) with dp = g . v; exact zeros elsewhere; dk and dq take the
    scale at the end. The products as the kernel's tensor cores take them:
    in bf16, P and dS rounded to bf16 before theirs, fp32 sums; in fp32,
    each product in three TF32 parts (``_mm_tf32x3``). Each gradient is
    cast to its input's dtype. The same function as ``attention_bwd`` up to
    those roundings; the tests hold one to the other."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    seq_k = Sk if seq_k is None else seq_k
    scale = 1.0 / math.sqrt(hd)
    n_rows = G * Sq
    step = bwd_step(hd, q.dtype)
    if q.dtype == torch.bfloat16:
        mm = torch.einsum

        def rnd(x):
            return x.to(torch.bfloat16).float()
    else:
        mm, rnd = _mm_tf32x3, (lambda x: x)

    def rows_of(x):
        return x.float().reshape(B, KV, G, Sq, -1).transpose(2, 3) \
            .reshape(B, KV, n_rows, -1)
    qr, gr = rows_of(q), rows_of(g)
    delta = (gr * rows_of(o)).sum(-1)
    lr = rows_of(lse.float()[..., None])[..., 0]
    n_kt = -(-Sk // BWD_HELD)
    kp = q.new_zeros(B, KV, n_kt * BWD_HELD, hd, dtype=torch.float32)
    vp = torch.zeros_like(kp)
    kp[:, :, :Sk], vp[:, :, :Sk] = k.float(), v.float()

    def live(rows, cols):
        pos = (rows // G)[:, None] + q_offset
        ok = (cols < seq_k)[None, :].expand(len(rows), -1)
        if causal:
            ok = ok & (cols[None, :] <= pos)
        if window > 0:
            ok = ok & (cols[None, :] > pos - window)
        return ok

    def pair_grads(rows, cols):
        kt, vt = kp[:, :, cols], vp[:, :, cols]
        lv = live(rows, cols)
        s = mm("bkrd,bkjd->bkrj", qr[:, :, rows], kt) * scale
        p = torch.where(lv, torch.exp(s - lr[:, :, rows, None]), 0.0)
        dp = mm("bkrd,bkjd->bkrj", gr[:, :, rows], vt)
        ds = torch.where(lv, p * (dp - delta[:, :, rows, None]), 0.0)
        return rnd(p), rnd(ds)

    def arange(lo, hi):
        return torch.arange(lo, hi, device=q.device)

    seg, _, qseg, _ = bwd_segments(B, KV, Sq, Sk, seq_k, causal, window,
                                   q_offset, G, step)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for t in range(n_kt):                                         # (b)
        cols = arange(t * BWD_HELD, (t + 1) * BWD_HELD)
        tiles = list(live_query_tiles(t * BWD_HELD, (t + 1) * BWD_HELD - 1,
                                      Sq, seq_k, causal, window, step,
                                      q_offset, G))
        for s0 in range(0, len(tiles), seg):
            part_k = kp.new_zeros(B, KV, BWD_HELD, hd)
            part_v = torch.zeros_like(part_k)
            for u in tiles[s0:s0 + seg]:
                rows = arange(u * step, min((u + 1) * step, n_rows))
                p, ds = pair_grads(rows, cols)
                part_v += mm("bkrj,bkrd->bkjd", p, gr[:, :, rows])
                part_k += mm("bkrj,bkrd->bkjd", ds, qr[:, :, rows])
            dv[:, :, cols] += part_v
            dk[:, :, cols] += part_k
    dq = torch.zeros_like(qr)
    for r0 in range(0, n_rows, BWD_HELD):                         # (c)
        rows = arange(r0, min(r0 + BWD_HELD, n_rows))
        tiles = list(live_key_tiles(r0 // G, int(rows[-1]) // G, Sq, seq_k,
                                    causal, window, step, q_offset))
        for s0 in range(0, len(tiles), qseg):
            part = qr.new_zeros(B, KV, len(rows), hd)
            for t in tiles[s0:s0 + qseg]:
                cols = arange(t * step, (t + 1) * step)
                _, ds = pair_grads(rows, cols)
                part += mm("bkrj,bkjd->bkrd", ds, kp[:, :, cols])
            dq[:, :, rows] += part
    dq = (dq * scale).reshape(B, KV, Sq, G, hd).transpose(2, 3) \
        .reshape(B, H, Sq, hd)
    return (dq.to(q.dtype), (dk[:, :, :Sk] * scale).to(k.dtype),
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
                         seq_q=None, seq_k=None, q_offset=0,
                         return_lse=False):
    """q (B,H,Sq,hd); k/v (B,KV,Sk,hd). Returns (B,H,Sq,hd) in q's dtype;
    with ``return_lse`` also each row's log-sum-exp (B,H,Sq) fp32, which
    the gradient takes (a one-query call then runs the sequence form,
    whose kernels write it)."""
    B, H, Sq, hd = q.shape
    q_offset = int(q_offset)
    work = lambda: cost.flash_work(                              # noqa: E731
        B, H, k.shape[1], Sq, k.shape[2] if seq_k is None else seq_k, hd,
        q.element_size(), k.element_size(), causal, window, q_offset)
    with cost.counted("flashattn", work):
        if q.device.type == "meta":
            o = torch.empty_like(q)
            return (o, q.new_empty(B, H, Sq, dtype=torch.float32)) \
                if return_lse else o
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, seq_q=seq_q, seq_k=seq_k,
                                 q_offset=q_offset, return_lse=return_lse)
        if q.device.type != "cuda":
            raise ValueError(f"{NAME}: no kernel for {q.device}")
        seq_q, seq_k = _check(q, k, v, seq_q, seq_k, q_offset)
        if q.shape[2] == 1 and not return_lse:
            if q_offset:
                return _launch_decode_at(q, k, v, causal, window, softcap,
                                         seq_q, seq_k, q_offset)
            return _launch_decode(q, k, v, causal, softcap, seq_q, seq_k)
        return _launch_seq(q, k, v, causal, window, softcap, seq_q, seq_k,
                           q_offset, return_lse)


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


def _launch_seq(q, k, v, causal, window, softcap, seq_q, seq_k, q_offset=0,
                return_lse=False):
    """Sq > 1 (or any Sq with ``return_lse``): contiguous q, k, v; bf16 K/V
    beside an fp32 q are widened first (the fp32 kernel reads fp32)."""
    if k.dtype != q.dtype:
        k, v = k.float(), v.float()
    dev = _cuda.check_cuda_tensors(NAME, (q, k, v),
                                   (DTYPES, (q.dtype,), (q.dtype,)))
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=dev) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    err = _cuda.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, KV, Sq, Sk, hd, seq_q,
        seq_k, int(bool(causal)), int(window), q_offset, float(softcap),
        _cuda.DTYPE_CODES[q.dtype], *_cuda.device_and_stream(dev))
    _cuda.check_launch(NAME, err, "seq_f32" if q.dtype == torch.float32
                       else "seq_bf16")
    return (out, lse) if return_lse else out


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


def flash_attention_bwd_bhsd(q, k, v, o, g, *, lse=None, causal=True,
                             window=0, seq_k=None, q_offset=0):
    """dq, dk, dv of ``flash_attention_bhsd`` (no softcap) at the output
    ``o``, its log-sum-exp ``lse`` (B,H,Sq) fp32 (the forward's,
    ``return_lse``) and its gradient ``g`` (B,H,Sq,hd), K/V in q's dtype;
    each in its input's dtype. CPU tensors: the plain ``attention_bwd``, at
    ``attention_lse`` where no lse is given; CUDA tensors: the gradient
    kernel, which needs lse, one launch counted under the ``backward`` form
    (three kernels: delta, dK/dV, dq). Reports ``cost.flash_bwd_work`` under
    ``flashattn``."""
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
            if lse is None:
                lse = attention_lse(q, k, causal=causal, window=window,
                                    seq_k=seq_k, q_offset=q_offset)
            return attention_bwd(q, k, v, o, lse, g, causal=causal,
                                 window=window, seq_k=seq_k,
                                 q_offset=q_offset)
        if q.device.type != "cuda":
            raise ValueError(f"{NAME}: no gradient kernel for {q.device}")
        return _launch_bwd(q, k, v, o, g, lse, causal, window, seq_k,
                           q_offset)


def _launch_bwd(q, k, v, o, g, lse, causal, window, seq_k, q_offset,
                segments=None):
    """Contiguous, 16-byte aligned q, k, v, o, g of one dtype and the
    forward's lse; the walks cut as ``bwd_segments`` cuts them, or as
    ``segments`` (its four numbers) says."""
    _, seq_k = _check(q, k, v, None, seq_k, q_offset)
    if lse is None:
        raise ValueError(f"{NAME} backward: the gradient kernel takes the "
                         f"forward's lse (flash_attention_bhsd(..., "
                         f"return_lse=True))")
    dt = (q.dtype,)
    dev = _cuda.check_cuda_tensors(NAME, (q, k, v, o, g, lse),
                                   (DTYPES, dt, dt, dt, dt, (torch.float32,)))
    B, H, Sq, hd = q.shape
    if o.shape != q.shape or g.shape != q.shape or window < 0 \
            or lse.shape != (B, H, Sq):
        raise ValueError(f"{NAME} backward: q {tuple(q.shape)}, o "
                         f"{tuple(o.shape)}, g {tuple(g.shape)}, lse "
                         f"{tuple(lse.shape)}, window {window}")
    if any(x.data_ptr() % 16 for x in (q, k, v, o, g)):
        raise ValueError(f"{NAME} backward: the kernel reads rows in 16-byte "
                         f"pieces: every input must start 16-byte aligned")
    KV, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0:
        return dq, dk, dv
    seg, nseg, qseg, qnseg = segments or bwd_segments(
        B, KV, Sq, Sk, seq_k, causal, window, q_offset, H // KV,
        bwd_step(hd, q.dtype))
    delta = torch.empty(B * H * Sq, dtype=torch.float32, device=dev)
    # the segments' fp32 sums: dK and dV of every key a dK/dV segment, dq
    # of every row a dq segment
    kpart = torch.empty(2 * nseg * k.numel(), dtype=torch.float32,
                        device=dev) if nseg > 1 else None
    qpart = torch.empty(qnseg * q.numel(), dtype=torch.float32,
                        device=dev) if qnseg > 1 else None
    err = _cuda.lib().repro_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), None if kpart is None else kpart.data_ptr(),
        None if qpart is None else qpart.data_ptr(), B, H, KV, Sq, Sk, hd,
        seq_k, int(bool(causal)), int(window), q_offset, seg, nseg, qseg,
        qnseg, _cuda.DTYPE_CODES[q.dtype], *_cuda.device_and_stream(dev))
    _cuda.check_launch(NAME, err, "backward")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention_bhsd`` with a gradient: the forward is the wrapper
    as it is (one kernel launch on CUDA tensors, which also writes each
    row's lse for the backward, as the reference's ``_flash_xla_fwd``
    saves it), the backward ``flash_attention_bwd_bhsd`` (on CUDA tensors
    one launch of the gradient kernel, handed fresh contiguous tensors:
    autograd's g is a transposed view; on CPU tensors the plain backward,
    which recomputes lse). Autograd runs a CUDA backward on a thread of its
    own; its launch counts where the forward's did (``_cuda.resume``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, seq_k, q_offset):
        kw = dict(causal=causal, window=window, seq_k=seq_k,
                  q_offset=q_offset)
        if q.device.type == "cuda":
            o, lse = flash_attention_bhsd(q, k, v, return_lse=True, **kw)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = flash_attention_bhsd(q, k, v, **kw)
            ctx.save_for_backward(q, k, v, o)
        ctx.args = kw
        ctx.running = _cuda.running()
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, *lse = ctx.saved_tensors
        if q.device.type == "cuda":
            q, k, v, o = (_cuda.fresh(x) for x in (q, k, v, o))
            g = _cuda.fresh(g.to(q.dtype))
        with _cuda.resume(ctx.running):
            dq, dk, dv = flash_attention_bwd_bhsd(
                q, k, v, o, g, lse=lse[0] if lse else None, **ctx.args)
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
