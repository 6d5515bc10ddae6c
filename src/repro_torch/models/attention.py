"""GQA attention: full-sequence (causal, local-window, bidirectional and
cross), dense (ring) cache prefill and decode, the read-only cross cache
of an encoder-decoder and its one-token read, paged prefill and paged
decode.

Layouts: q proj (d, H, hd); k/v proj (d, KV, hd); o proj (H, hd, d).
With ``cfg.qk_norm`` (qwen3, llama4) each query and key head is
RMS-normalized over hd by ``q_norm`` / ``k_norm`` (hd,) before RoPE.

The sequence mixing always goes through ``kernels.ops``: the flash kernel
for full sequences, prompts, cross-attention and one token over a dense or
cross cache (the reference's ``attn_impl="pallas"`` branch; its prompt
prefill, encoder, cross-attention and dense decode use a masked softmax,
the same function) and the paged decode kernel for one token over pages.
On CPU tensors those run their plain versions.

On a mesh (``distributed.sharding``) a dense cache is the rank's shard as
``sharding.cache_spec_tree`` places it (``_cache_split``): its KV heads
where they divide ``model``, else its slice of every KV head's head dim,
whose new K/V each rank projects whole (the rules replicate ``wk`` /
``wv`` there) and keeps its slice of; a decode step then gathers the
cache's head dims over ``model`` (``gather_from_model``) before flash,
which takes whole heads, and hands flash the KV heads the rank's query
heads read.

In a train step whose residual stream is split over ``model``
(``sharding.seq_split``, ``sp``: x is the rank's chunk of the sequence)
the head-split projections take the gathered sequence (``gather_seq``) and
the output projection's partial sums are reduce-scattered back onto the
chunk (``scatter_seq``). Where the rules replicate the attention weights
because the query heads do not divide ``model``
(``sharding.context_parallel``, or any ``sp`` step there), each rank
computes its chunk of the query sequence (``_cp_qkv``): Q from its chunk's
rows, K/V of every position (all KV heads), flash told the chunk's first
position (``q_offset``), the output projection on the chunk; without
``sp`` the chunks' outputs are gathered back into the replicated residual
(``_cp_out``). The weights then take ``use="partial"``: each rank's
gradient covers its queries' share. A prefill under the train rules takes
this and never ``sp``, as the reference's prefill has no residual
constraint; its cache writes are unchanged, K/V being whole on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (apply_rope, at_use, cast, rms_norm,
                                       torch_dtype, weight)


class Attention(nn.Module):
    def __init__(self, cfg, gen=None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = torch_dtype(cfg.param_dtype)
        self.wq = weight(gen, (d, H, hd), d, dt)
        self.wk = weight(gen, (d, KV, hd), d, dt)
        self.wv = weight(gen, (d, KV, hd), d, dt)
        self.wo = weight(gen, (H, hd, d), H * hd, dt)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, dtype=dt),
                                       requires_grad=False)
            self.k_norm = nn.Parameter(torch.ones(hd, dtype=dt),
                                       requires_grad=False)


def _q(p, x, cfg, w=None, use="local"):
    """Query heads (B,S,H,hd), qk-normed where the config says so: ``w``
    is the projection as used (default ``wq`` at the compute dtype); ``use``
    is the norm scale's (``sharding.gather``)."""
    q = sharding.dot(x, p.wq, at_use(p.wq, x, cfg) if w is None else w,
                     "bsd,dhk->bshk")
    return rms_norm(q, p.q_norm, cfg.norm_eps, use) if cfg.qk_norm else q


def _kv(p, x, cfg, heads=None, use="local", wuse="local"):
    """Key and value heads (B,S,KV,hd), the keys qk-normed where the
    config says so; ``heads`` the KV heads to compute (all where None),
    from projections each rank slices (``use="partial"``); ``use`` is the
    norm scale's, ``wuse`` the projections' where ``heads`` is None."""
    k = sharding.dot(x, p.wk, at_use(p.wk, x, cfg, heads, 1, wuse),
                     "bsd,dhk->bshk")
    v = sharding.dot(x, p.wv, at_use(p.wv, x, cfg, heads, 1, wuse),
                     "bsd,dhk->bshk")
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm, cfg.norm_eps, use)
    return k, v


def _split(p):
    """Whether attention computes this rank's heads: a tensor-parallel
    step whose rules split ``wq``'s heads over ``model`` (they replicate it
    where the heads do not divide: then ``_cp``)."""
    return sharding.split_lo(p.wq, 1) is not None


def _kv_heads(p, cfg, n_q):
    """The KV heads that this rank's ``n_q`` query heads read, where the
    rules replicate ``wk`` / ``wv`` (the KV heads do not divide ``model``):
    query head ``h`` reads KV head ``h // (H / KV)``. One entry a distinct
    KV head where they group evenly (flash then pairs local query head
    ``j`` with entry ``j // (n_q / entries)``, as GQA does), else one a
    query head; None where ``wk`` is split, whose shard is the KV heads the
    rank's query heads read."""
    if sharding.split_lo(p.wk, 1) is not None:
        return None
    h0 = sharding.split_lo(p.wq, 1)
    group = cfg.n_heads // cfg.n_kv_heads
    reads = [(h0 + j) // group for j in range(n_q)]
    kv = sorted(set(reads))
    even = n_q % len(kv) == 0 and reads == [
        h for h in kv for _ in range(n_q // len(kv))]
    return kv if even else reads


def _project(p, x, kv_x, cfg, cached=False, sp=False):
    """(q (B,S,H,hd), k, v (B,T,KV,hd)) from x and kv_x, before RoPE. In a
    tensor-parallel step with ``wq`` split, this rank's query heads and the
    KV heads they read (``_kv_heads``), each input behind
    ``copy_to_model`` (x gathered over the sequence by ``gather_seq``
    instead with ``sp``); never the local query heads beside all KV heads,
    which flash's GQA mapping would pair wrongly (``_reads`` picks a
    cache's). ``cached``: K/V for a cache, every KV head of the rank's
    ``wk`` (its own where ``wk`` is split, else all of them)."""
    if not _split(p):
        return (_q(p, x, cfg),) + _kv(p, kv_x, cfg)
    xc = sharding.gather_seq(x) if sp else sharding.copy_to_model(x)
    kc = xc if kv_x is x else sharding.copy_to_model(kv_x)
    q = _q(p, xc, cfg, use="partial")
    heads = None if cached else _kv_heads(p, cfg, q.shape[2])
    return (q,) + _kv(p, kc, cfg, heads, "partial")


def _qkv(p, x, positions, cfg, cached=False, sp=False):
    q, k, v = _project(p, x, x, cfg, cached, sp)
    return apply_rope(q, positions, cfg), apply_rope(k, positions, cfg), v


def _proj_out(p, out, cfg, sp=False):
    """The output projection; in a tensor-parallel step over this rank's
    heads' rows of ``wo``, summed over ``model`` (reduce-scattered onto
    the rank's chunk of the sequence with ``sp``)."""
    y = sharding.dot(out, p.wo, at_use(p.wo, out, cfg), "bshk,hkd->bsd")
    if not _split(p):
        return y
    return sharding.scatter_seq(y) if sp else sharding.reduce_from_model(y)


def _cp(p, cfg, S, sp):
    """Whether attention over ``S`` queries (the whole sequence's count)
    computes this rank's chunk of them: the weights replicated (``wq`` not
    split) and a sequence-parallel step (its rows are the chunk) or
    ``sharding.context_parallel``."""
    return not _split(p) and (sp or sharding.context_parallel(cfg.n_heads,
                                                               S))


def _cp_qkv(p, x, kv_x, positions, cfg, sp, rope=True):
    """Context parallelism's projections: (q (B,S/m,H,hd) of this rank's
    chunk of the queries, k, v (B,T,KV,hd) of every position and KV head,
    the chunk's first position). With ``sp`` ``x`` is the chunk itself and
    the keys' rows are gathered (``gather_seq``: each rank's K/V gradient
    is its queries' share, summed); without, ``x`` is whole on every rank
    and ``copy_to_model`` stands before both uses. ``positions`` (S,):
    the whole sequence's, for RoPE where ``rope``."""
    t = sharding.tp()
    if sp:
        xq = x
        kx = sharding.gather_seq(x) if kv_x is x \
            else sharding.copy_to_model(kv_x)
    else:
        xc = sharding.copy_to_model(x)
        xq = xc[:, sharding.rank_slice(xc.shape[1])]
        kx = xc if kv_x is x else sharding.copy_to_model(kv_x)
    n = xq.shape[1]
    lo = t.rank * n
    q = _q(p, xq, cfg, at_use(p.wq, xq, cfg, use="partial"), "partial")
    k, v = _kv(p, kx, cfg, None, "partial", "partial")
    if rope:
        q = apply_rope(q, positions[lo:lo + n], cfg)
        k = apply_rope(k, positions, cfg)
    return q, k, v, lo


def _cp_out(p, out, cfg, sp):
    """The output projection of a context-parallel chunk (``wo``
    replicated, its gradient the chunk's share); without ``sp`` the
    chunks gathered along the sequence into the replicated residual
    (``gather_from_model``: its gradient is the same on every rank, each
    keeps its chunk's)."""
    y = sharding.dot(out, p.wo, at_use(p.wo, out, cfg, use="partial"),
                     "bshk,hkd->bsd")
    return y if sp else sharding.gather_from_model(y, 1)


def _cache_split(cfg):
    """How a tensor-parallel step's K/V caches split over ``model``, as
    ``sharding.cache_spec`` places them: "heads" (the rank's KV heads, where
    they divide ``model``), "head_dim" (its slice of every KV head's head
    dim), or None (off a split, or neither divides: whole)."""
    t = sharding.tp()
    if t.size == 1:
        return None
    spec = sharding.cache_spec("0/0_attn/k", (1, 1, 1, cfg.n_kv_heads,
                                              cfg.head_dim), t.mesh, cfg)
    if spec[-2] and "model" in spec[-2]:
        return "heads"
    if spec[-1] and "model" in spec[-1]:
        return "head_dim"
    return None


def _own(kv, cfg):
    """The part of new K or V (..., KV, hd) that this rank's cache holds:
    its head-dim slice where the cache splits the head dim."""
    if _cache_split(cfg) != "head_dim":
        return kv
    return kv[..., sharding.rank_slice(cfg.head_dim)]


def _whole(kv, cfg):
    """A cache's K or V with whole head dims, as the kernels take them:
    every rank's head-dim slice gathered over ``model``
    (``gather_from_model``) where the cache splits the head dim."""
    if _cache_split(cfg) != "head_dim":
        return kv
    return sharding.gather_from_model(kv)


def _reads(p, cfg, q, k, v):
    """K/V (B,T,KV,hd) of every head of the rank's ``wk`` (``cached``) as
    flash pairs them with this rank's query heads q: the KV heads they read
    (``_kv_heads``) where ``wq`` is split and ``wk`` is not."""
    heads = _kv_heads(p, cfg, q.shape[2]) if _split(p) else None
    if heads is None:
        return k, v
    return k[:, :, heads], v[:, :, heads]


def make_mask(q_pos, k_pos, causal: bool, window: int):
    """Boolean mask (..., S, T): True = attend. Positions may be (S,)/(T,)
    or batched (B, S)/(B, T); invalid cache slots carry position -1."""
    q = q_pos[..., :, None]
    kk = k_pos[..., None, :]
    m = kk >= 0
    if causal:
        m = m & (kk <= q)
    if window > 0:
        m = m & (kk > q - window)
    return m


def attn_fwd(p, x, positions, cfg, *, causal=True, window=0, sp=False):
    """Full-sequence self-attention through the flash kernel, which masks
    by index: ``positions`` (arange over the whole sequence) only feed
    RoPE (``causal=False``: an encoder's). Cross-attention is
    ``cross_prefill``. With ``sp`` x is the rank's chunk of the sequence
    (``sharding.seq_split``), and so is the output. Returns (B,S,d)."""
    if _cp(p, cfg, positions.shape[0], sp):
        q, k, v, lo = _cp_qkv(p, x, x, positions, cfg, sp)
        out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=cfg.attn_logit_softcap,
                                   q_offset=lo)
        return _cp_out(p, out, cfg, sp)
    q, k, v = _qkv(p, x, positions, cfg, sp=sp)
    out = kops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cfg.attn_logit_softcap)
    return _proj_out(p, out, cfg, sp)


def init_cache(cfg, batch, length, window=0, dtype=None, device=None):
    """Dense cache for one attention layer: K/V (B, L, KV, hd) in the
    compute dtype, a ring of L = min(window, length) slots when
    ``window > 0``. Position p lives in slot p % L (for a full cache,
    L > p)."""
    dt = dtype or torch_dtype(cfg.compute_dtype)
    L = min(window, length) if window > 0 else length
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attn_prefill(p, x, positions, cfg, *, cache, window=0):
    """Causal (windowed) attention over the prompt through the flash
    kernel, writing K/V into the fresh cache in place. x (B,S,d); positions
    (S,) = arange(S). A prompt longer than the ring keeps its last L
    positions, rotated so that position p sits in slot p % L, the slot
    ``attn_decode`` reads and overwrites (the reference keeps them in slots
    0..L-1, which decode only agrees with when L divides S). Returns
    (out (B,S,d), cache). Under context parallelism (``_cp``) this rank's
    chunk of the queries attends, K/V whole."""
    S = x.shape[1]
    cp = _cp(p, cfg, S, False)
    if cp:
        q, k, v, lo = _cp_qkv(p, x, x, positions, cfg, False)
    else:
        q, k, v = _qkv(p, x, positions, cfg, cached=True)
    L = cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        new = _own(new, cfg)
        if L >= S:
            cache[name][:, :S] = new
        else:
            cache[name].copy_(torch.roll(new[:, S - L:], S % L, dims=1))
    if cp:
        out = kops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_logit_softcap,
                                   q_offset=lo)
        return _cp_out(p, out, cfg, False), cache
    k, v = _reads(p, cfg, q, k, v)
    out = kops.flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_logit_softcap)
    return _proj_out(p, out, cfg), cache


def attn_decode(p, x, t, cfg, *, cache, cross=False):
    """One-token decode over the dense cache. x (B,1,d); t the token's
    position. Writes K/V at slot t % L in place (t itself for a full
    cache, L > t), then attends over the filled slots, n = min(t + 1, L):
    every one of them lies inside the window, and the softmax does not
    depend on the slots' order, so the flash kernel runs unmasked with one
    query over them. It is handed the whole cache with ``seq_k = n`` (its
    key ranges then follow the cache's fixed length L, not n) and reads the
    first n slots in place, in their stored dtype (bf16 beside
    recurrentgemma's fp32 query, which the kernel widens as the reference's
    products promote). With ``cross`` the cache is an encoder's
    (``init_cross_cache``), read whole and left as it is: no RoPE, no
    write, and Q projected by ``wq`` cast to x's dtype, as the reference
    casts it there. Returns (out (B,1,d), cache)."""
    if cross:
        use = "local"
        if _split(p):
            x, use = sharding.copy_to_model(x), "partial"
        q = _q(p, x, cfg, cast(p.wq, x.dtype), use)
        k, v = _reads(p, cfg, q, _whole(cache["k"], cfg),
                      _whole(cache["v"], cfg))
        out = kops.flash_attention(q, k, v, causal=False,
                                   softcap=cfg.attn_logit_softcap)
        return _proj_out(p, out, cfg), cache
    q, k, v = _qkv(p, x, torch.full((1,), t, device=x.device), cfg,
                   cached=True)
    L = cache["k"].shape[1]
    cache["k"][:, t % L] = _own(k, cfg)[:, 0]
    cache["v"][:, t % L] = _own(v, cfg)[:, 0]
    n = min(t + 1, L)
    if _cache_split(cfg) == "head_dim":
        k, v = _reads(p, cfg, q, _whole(cache["k"][:, :n], cfg),
                      _whole(cache["v"][:, :n], cfg))
        out = kops.flash_attention(q, k, v, causal=False,
                                   softcap=cfg.attn_logit_softcap)
    else:
        k, v = _reads(p, cfg, q, cache["k"], cache["v"])
        out = kops.flash_attention(q, k, v, causal=False,
                                   softcap=cfg.attn_logit_softcap, seq_k=n)
    return _proj_out(p, out, cfg), cache


def init_cross_cache(p, enc_out, cfg):
    """The encoder's K/V for cross-attention (whisper's decoder), computed
    once at prefill and read by every decode step: {"k", "v"} (B, F, KV,
    hd) in the compute dtype. No RoPE (the reference's cross K/V have
    none)."""
    k, v = _kv(p, enc_out, cfg)
    return {"k": k, "v": v}


def cross_prefill(p, x, enc_out, cfg, cached=False, sp=False):
    """Cross-attention of x (B,S,d) over the encoder output (B,F,d) through
    the flash kernel, non-causal and without RoPE (the reference's
    ``attn_fwd(kv_x=enc_out, causal=False, rope=False)``), for the full
    forward and the prompt alike; the cross cache it builds is what
    ``attn_decode(cross=True)`` reads (with ``cached``, in a
    tensor-parallel step, the rank's shard of it, as ``attn_prefill``
    keeps a self cache's). Context parallelism (``_cp``) splits x's
    queries as ``attn_fwd``'s; ``sp`` as there. Returns (out (B,S,d),
    cache)."""
    S = x.shape[1] * (sharding.tp().size if sp else 1)
    cp = _cp(p, cfg, S, sp)
    if cp:
        q, k, v, lo = _cp_qkv(p, x, enc_out, None, cfg, sp, rope=False)
    else:
        q, k, v = _project(p, x, enc_out, cfg, cached, sp)
    cache = {"k": _own(k, cfg), "v": _own(v, cfg)} if cached \
        else {"k": k, "v": v}
    if cp:
        out = kops.flash_attention(q, k, v, causal=False,
                                   softcap=cfg.attn_logit_softcap,
                                   q_offset=lo)
        return _cp_out(p, out, cfg, sp), cache
    k, v = _reads(p, cfg, q, k, v) if cached else (k, v)
    out = kops.flash_attention(q, k, v, causal=False,
                               softcap=cfg.attn_logit_softcap)
    return _proj_out(p, out, cfg, sp), cache


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
