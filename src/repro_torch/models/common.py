"""Shared model building blocks: init helper, norms, embeddings, RoPE,
activations.

Parameters live in ``nn.Module``s in the reference's layouts (so the bridge
from the JAX package is a plain copy), created in ``cfg.param_dtype`` and
cast to ``cfg.compute_dtype`` at use. The forward functions are plain
functions on tensors that take those modules, like the reference's
functions take its parameter dicts.

Every read of a parameter goes through ``cast`` (``at_use`` for a weight
against an activation): a parameter stored sharded as a DTensor
(``distributed.sharding.shard_module``) is gathered there, its local shard
cast first, so a layer always computes on plain local tensors: in a
tensor-parallel step the rank's ``model`` shard of it
(``sharding.gather``), and the layer computes its heads, channels or
vocab entries (``sharding.split_lo``); in a serve step also the weight's
``"data2d"`` slice, which the product multiplies where it lies
(``sharding.dot``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import gather, is_dtensor


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` -> the torch dtype."""
    return getattr(torch, name)


DRAW_SLICE = 1 << 27     # elements of one fp32 draw of a non-fp32 weight


def dense_init(gen, shape, in_axis_size, dtype=torch.float32, rows=None):
    """Fan-in scaled normal init drawn from ``gen`` on the generator's own
    device: a CPU generator gives the same weights wherever they are copied
    to, a CUDA one draws them on the card without a host copy. The draw is
    fp32; a weight of another dtype is drawn in slices of its leading axis
    of at most ``DRAW_SLICE`` elements, each cast into the weight's own
    storage, so the fp32 temporary is one slice (llama4's (128, 5120,
    8192) bf16 experts would need 21.5 GB of fp32 beside their 10.7 GB
    otherwise). ``rows``: the slice of the leading axis to keep; every
    slice is drawn as without it and the rest dropped, so the kept rows
    are bitwise the whole draw's (a rank's experts,
    ``moe.local_experts``)."""
    scale = float(1.0 / np.sqrt(max(in_axis_size, 1)))
    if dtype == torch.float32 or not shape:
        w = torch.randn(shape, generator=gen, device=gen.device)
        w = w.mul_(scale).to(dtype)
        return w if rows is None else w[rows].clone()
    lo, hi = (0, shape[0]) if rows is None else (rows.start, rows.stop)
    out = torch.empty((hi - lo,) + tuple(shape[1:]), dtype=dtype,
                      device=gen.device)
    step = max(1, DRAW_SLICE // max(1, out[0].numel()))
    for a in range(0, shape[0], step):
        b = min(a + step, shape[0])
        part = torch.randn((b - a,) + tuple(shape[1:]), generator=gen,
                           device=gen.device)
        if a < hi and b > lo:
            out[max(a, lo) - lo:min(b, hi) - lo].copy_(
                part[max(a, lo) - a:min(b, hi) - a].mul_(scale))
    return out


def weight(gen, shape, in_axis_size, dtype, rows=None) -> nn.Parameter:
    """A parameter from ``dense_init``, or zeros to be filled by a copy (the
    bridge) when ``gen`` is None. Served weights take no gradients; a
    finetune trains a ``trainable`` copy. With ``rows`` it holds only those
    rows of the leading axis, and ``whole_shape`` says the whole weight's
    shape (``sharding.shard_module`` makes it the rank's shard)."""
    data = (dense_init(gen, shape, in_axis_size, dtype, rows)
            if gen is not None else torch.zeros(shape, dtype=dtype)[
                slice(None) if rows is None else rows])
    out = nn.Parameter(data, requires_grad=False)
    if rows is not None:
        out.whole_shape = tuple(shape)
    return out


def trainable(module, device=None):
    """A copy of ``module`` (on ``device``, default its own) whose
    parameters are fp32 leaves with ``requires_grad=True``, for training;
    ``module`` itself is left as it is. Made outside inference mode, so the
    copy holds normal tensors even where ``module``'s are inference
    tensors (a payload's per-device copies are)."""
    with torch.inference_mode(False):
        out = copy.deepcopy(module).to(device=device, dtype=torch.float32)
    return out.requires_grad_(True)


class Norm(nn.Module):
    def __init__(self, cfg, dim=None):
        super().__init__()
        d = dim or cfg.d_model
        dt = torch_dtype(cfg.param_dtype)
        self.scale = nn.Parameter(torch.ones(d, dtype=dt), requires_grad=False)
        if cfg.norm_type == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dt),
                                     requires_grad=False)


class Embedding(nn.Module):
    def __init__(self, cfg, gen=None):
        super().__init__()
        self.tok = weight(gen, (cfg.padded_vocab, cfg.d_model), cfg.d_model,
                          torch_dtype(cfg.param_dtype))


class Dense(nn.Module):
    """One weight ``w`` (the LM head, the structure projection)."""

    def __init__(self, shape, in_axis_size, dtype, gen=None):
        super().__init__()
        self.w = weight(gen, shape, in_axis_size, dtype)


def norm_fwd(p, x, cfg, use="local"):
    """RMS or layer norm over the last dim; ``use``: the scale's and bias's
    (``sharding.gather``; "partial" on a sequence-parallel chunk, whose
    rows are the rank's own)."""
    dt = x.dtype
    x = x.float()
    if cfg.norm_type == "layernorm":
        x = x - x.mean(-1, keepdim=True)
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + cfg.norm_eps)
    x = x * cast(p.scale, torch.float32, use)
    if cfg.norm_type == "layernorm":
        x = x + cast(p.bias, torch.float32, use)
    return x.to(dt)


def rms_norm(x, scale, eps=1e-6, use="local"):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * cast(scale, torch.float32, use)).to(dt)


def gumbel_noise(gen, shape, device):
    """Standard Gumbel draws from ``gen`` on ``device`` (fp32)."""
    u = torch.rand(shape, generator=gen, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def cast(w, dtype, use="local"):
    """Parameter ``w`` in ``dtype`` as a layer uses it: a plain tensor cast,
    a DTensor's local shard cast, then gathered (``sharding.gather``, where
    ``use`` says what a tensor-parallel step takes of it)."""
    return gather(w, dtype, use) if is_dtensor(w) else w.to(dtype)


def cast_part(w, dtype, part, dim=-1, use="local"):
    """The ``part`` (a slice or a list of indices of dim ``dim``) of
    replicated parameter ``w`` that this rank's heads or channels read in a
    tensor-parallel step, in ``dtype``; its gradient is summed over
    ``model``. All of ``w`` (``cast`` with ``use``) where ``part`` is
    None."""
    if part is None:
        return cast(w, dtype, use)
    full = cast(w, dtype, "partial")
    return full[(slice(None),) * (dim % full.dim()) + (part,)]


def at_use(w, x, cfg, part=None, dim=-1, use="local"):
    """Weight ``w`` as the reference uses it against activation ``x``: cast
    to ``cfg.compute_dtype``, then promoted with ``x``'s dtype as JAX
    promotes a product. The identity beyond the cast when ``x`` is already
    in the compute dtype; with fp32 ``x`` and bf16 compute (recurrentgemma's
    residual stream, see ``embed_tokens``) the weight is rounded to bf16 and
    the product runs in fp32. ``part``: the entries of dim ``dim`` that
    this rank reads of a replicated weight (``cast_part``); ``use`` as
    ``sharding.gather`` takes it ("partial": a replicated weight that each
    rank applies to its own rows, a context- or sequence-parallel
    chunk)."""
    cdt = torch_dtype(cfg.compute_dtype)
    return cast_part(w, cdt, part, dim, use).to(
        torch.promote_types(x.dtype, cdt))


def embed_tokens(p, tokens, cfg, prefix=None, sp=False):
    """Token embeddings in the compute dtype. With ``emb_scale`` the
    reference multiplies them by ``np.sqrt(d).astype(np.float32)``, a numpy
    scalar, which JAX promotes as an fp32 array: the result is fp32 (the
    embedding rounded to the compute dtype, then scaled in fp32), and the
    model's residual stream stays fp32 from there on. A sharded table is
    gathered in its own dtype, then indexed as a plain one is: the lookup's
    backward then sums repeated tokens' gradients in the parameter's dtype,
    as unsharded, not in the compute dtype. In a tensor-parallel step the
    table is split over the vocab: each rank looks up the tokens of its
    rows, zeros for the others, and the ranks' lookups are summed
    (``reduce_from_model``; one rank's value and zeros, so exact). In a
    serve step whose table is split over ``data`` too (its ``"data2d"``
    columns), the ``data`` ranks' token ids are gathered, each looks up
    its columns of them, and the columns are summed into whole rows
    (``columns_over_data``), of which the rank keeps its own.

    ``prefix`` (B, P, d): patches put in front of the token embeddings,
    cast to their dtype (the reference's ``_prefix_embed``). With ``sp``
    (``sharding.seq_split`` of the P + S positions) the residual stream is
    split over ``model`` from here on: the ranks' lookups are summed by a
    reduce-scatter after the prefix is put in front (``scatter_seq``; the
    prefix is rank 0's, zeros on the others, so the sum stays exact), and
    the rank keeps its chunk of the positions; ``emb_scale`` then scales
    each rank's lookup before the sum (exact likewise)."""
    tok = cast(p.tok, p.tok.dtype) if is_dtensor(p.tok) else p.tok
    lo = sharding.split_lo(p.tok, 0)
    cdt = torch_dtype(cfg.compute_dtype)
    columns = tok.shape[1] < p.tok.shape[1]    # its "data2d" slice: serving
    ids = tokens.long()
    if columns:
        ids = sharding.rows_over_data(ids)
    if lo is None:
        x = tok[ids].to(cdt)
    else:
        ids = ids - lo
        own = ((ids >= 0) & (ids < tok.shape[0]))[..., None]
        rows = tok[ids.clamp(0, tok.shape[0] - 1)]
        x = torch.where(own, rows, torch.zeros_like(rows)).to(cdt)
        if not sp:
            x = sharding.reduce_from_model(x)
    if columns:
        x = sharding.own_rows(sharding.columns_over_data(x), tokens.shape[0])
    if cfg.emb_scale:
        x = x.float() * float(np.float32(np.sqrt(cfg.d_model)))
    if prefix is not None:
        pre = prefix.to(x.dtype)
        if sp and lo is not None and sharding.tp().rank:
            pre = torch.zeros_like(pre)
        x = torch.cat([pre, x], dim=1)
    return sharding.scatter_seq(x, reduce=lo is not None) if sp else x


def logits_fwd(params, x, cfg):
    """Final norm + LM head. ``params`` is the top-level LM module. In a
    tensor-parallel step where the head (or the tied table) is split over
    the vocab, the logits of this rank's vocab entries, from
    ``vocab_lo(params, cfg)`` on."""
    return head_fwd(params, head_input(params, x, cfg), cfg)


def head_input(params, x, cfg, sp=False):
    """The final norm of hidden ``x``, then what stands before the LM head
    in a tensor-parallel step whose head is split over the vocab:
    ``copy_to_model`` (each rank's product gives its vocab slice's share of
    the gradient). With ``sp`` ``x`` is the rank's chunk of the sequence:
    the norm runs on the chunk (its scale's gradient summed over
    ``model``) and the chunks are gathered, by ``gather_seq`` before a
    split head (its backward sums the slices' shares and keeps the
    chunk's), else by ``gather_from_model`` (every rank computes the same
    head, so it keeps its chunk of one gradient)."""
    x = norm_fwd(params.final_norm, x, cfg, "partial" if sp else "local")
    split = vocab_lo(params, cfg) is not None
    if sp:
        return (sharding.gather_seq(x) if split
                else sharding.gather_from_model(x, 1))
    return sharding.copy_to_model(x) if split else x


def head_fwd(params, x, cfg):
    """The LM head on ``head_input``'s output: the logits (of this rank's
    vocab entries where the head is split)."""
    if cfg.tie_embeddings:
        tok = params.embedding.tok
        return sharding.dot(x, tok, at_use(tok, x, cfg), "...i,oi->...o")
    return sharding.dot(x, params.lm_head.w, at_use(params.lm_head.w, x, cfg))


def vocab_lo(params, cfg):
    """The first vocab entry of this rank's logits when the step is
    tensor-parallel and the head is split over the vocab, else None."""
    if cfg.tie_embeddings:
        return sharding.split_lo(params.embedding.tok, 0)
    return sharding.split_lo(params.lm_head.w, 1)


def rope_angles(positions, head_dim, cfg):
    """positions (..., S) int -> ((..., S, rot/2) fp32 angles, rot)."""
    rot = int(head_dim * cfg.rope_fraction)
    rot -= rot % 2
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, rot, 2, np.float32) / rot))
    inv = torch.from_numpy(np.asarray(inv, np.float32)).to(positions.device)
    return positions[..., None].float() * inv, rot


def apply_rope(x, positions, cfg):
    """Rotate the first ``rot`` dims of each head (``rope_fraction`` of the
    head dim), in the "half" (llama: dim i with dim i + rot/2) or the
    "interleaved" (chatglm: dim 2i with dim 2i + 1) style. x: (B, S, H,
    hd); positions: (S,) or per-row (B, S)."""
    if cfg.rope_style not in ("half", "interleaved"):
        raise ValueError(f"rope style {cfg.rope_style!r} is not ported")
    ang, rot = rope_angles(positions, x.shape[-1], cfg)
    if rot == 0:
        return x
    sin, cos = torch.sin(ang), torch.cos(ang)        # (..., S, rot/2)
    if positions.dim() == 1:
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    xr, xp = x[..., :rot].float(), x[..., rot:]
    if cfg.rope_style == "interleaved":
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xr.shape)
    else:
        half = rot // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def squared_relu(x):
    return torch.square(F.relu(x))


# the reference's ``jax.nn.gelu`` is the tanh approximation (whisper's own
# GELU is exact; the reference's function is kept)
ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": squared_relu,
}
