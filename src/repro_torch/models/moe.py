"""Mixture-of-experts FFN: a router over ``moe_experts`` SwiGLU / GeGLU /
squared-ReLU / GELU experts, ``moe_top_k`` of them a token, and
llama4's shared expert beside them (a port of the reference's
``repro.models.moe``).

Two forms, as in the reference:

* ``moe_fwd_dense``: the exact (dropless) form. Every expert computes
  every token and the gate zeroes the unrouted ones.
* the capacity ("dropping") form, ``moe_fwd``'s default. Tokens are routed
  within groups (one a sequence by default); each expert takes at most
  C = ``capacity(tokens a group)`` of a group's choices, in token order,
  and the choices past C are dropped (their residual passes through). The
  choices are scattered into a (G, E·C, d) buffer, the experts run as one
  batched product over E, and each choice gathers its row back.

The router computes in fp32; the expert products in the compute dtype.
Top-k takes a stable descending sort of the router's probabilities, so
among equal probabilities the lower expert index comes first, as
``jax.lax.top_k`` orders them (``torch.topk`` promises no order there).

On a mesh the capacity form splits as the reference's constraints split it
(``sharding.moe_split``; no knob of its own):

* **Expert parallelism** (``moe_parallelism="ep"``, llama4, in a train
  step and a prefill; every serve step): every ``model`` rank routes and
  dispatches all of its data row's groups (the routing replicated, as the
  reference keeps its scatter local), then computes only its ``E /
  model`` experts' rows of the (G, E, C, d) buffer on its own shard of
  their weights (``use="local"``: no expert weight moves over ``model``,
  and each rank's gradient stays on its shard). Each rank combines the
  choices of its experts (a zero where another rank's expert owns a
  choice) and the partial outputs are summed over ``model``
  (``reduce_from_model``, or ``scatter_seq`` onto the rank's chunk under
  sequence parallelism, whose tokens ``gather_seq`` gathers first): for
  top-1 one rank's value and zeros, so exact. The input's gradient and
  the router's (``use="partial"``) are partials, summed over ``model``;
  the aux values, which every rank computes alike from the same routing,
  pass their gradient on rank 0 only (``grad_once``), so it enters the
  loss once. In a serve step of an ``"ep"`` config the experts also lie
  over ``data`` along ``f`` (``"data2d"``): the rank's expert rows of the
  dispatch are gathered over ``data`` (``rows_over_data``), each rank
  multiplies its ``f`` slice, ``wo``'s partial products are summed over
  ``data`` and the rank keeps its rows (``sharding.dot``'s pattern); a
  serve step of another config keeps its experts whole along ``f``.
* **Groups over every rank** (``moe_parallelism="fsdp"``, qwen3, in a
  train step and a prefill, where the groups divide dp x ``model``): each
  ``model`` rank routes and computes only its ``G / model`` groups with
  the experts gathered whole over ``data`` (their gradient summed over
  ``model``, ``use="partial"``), and the outputs go back to each rank's
  rows (``gather_from_model``); under sequence parallelism an all-to-all
  over ``model`` (``all_to_all_model``) hands each rank whole rows of its
  groups from every rank's chunk of the sequence, and another hands the
  outputs back. Each aux value is a mean over groups, so the ranks'
  means are summed over ``model`` and divided by its size.
* Elsewhere (off a mesh, a group count or an expert count that does not
  divide, the dense form) every rank computes every expert on all its
  rows, gathered whole, as before; under sequence parallelism the chunk
  is gathered first (``gather_from_model``) and the rank keeps its chunk
  of the output (``scatter_seq`` without a sum).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn

from repro_torch.distributed import cost, sharding
from repro_torch.models.common import (ACTIVATIONS, at_use, cast,
                                       torch_dtype, weight)
from repro_torch.models.mlp import GATES, Mlp, mlp_fwd

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


_ROWS = threading.local()


@contextlib.contextmanager
def local_experts(rows):
    """Build every ``Moe`` in the block with only ``rows`` (a slice of the
    expert axis, or None: all) of its expert weights, each drawn as the
    whole weight is (``common.dense_init``), so a rank of a mesh never
    holds every expert (``lm.init_lm`` with a mesh)."""
    saved = getattr(_ROWS, "rows", None)
    _ROWS.rows = rows
    try:
        yield
    finally:
        _ROWS.rows = saved


class Moe(nn.Module):
    """``router`` (d, E) fp32; ``wg``, ``wi`` (E, d, f) and ``wo`` (E, f, d)
    in the param dtype (``wg`` whatever the MLP type, as the reference
    builds it), their rows of ``local_experts`` where it is in force;
    ``shared``, an ``Mlp`` of width ``d_ff``, with
    ``moe_shared_expert``."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        d, E, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
        dt = torch_dtype(cfg.param_dtype)
        rows = getattr(_ROWS, "rows", None)
        self.router = weight(gen, (d, E), d, torch.float32)
        self.wg = weight(gen, (E, d, f), d, dt, rows)
        self.wi = weight(gen, (E, d, f), d, dt, rows)
        self.wo = weight(gen, (E, f, d), f, dt, rows)
        if cfg.moe_shared_expert:
            self.shared = Mlp(cfg, gen)


def capacity(n_group_tokens: int, cfg) -> int:
    """Slots an expert takes a group: ceil(tokens x top_k x capacity
    factor / experts), rounded up to a multiple of 8 and at least 8."""
    c = math.ceil(n_group_tokens * cfg.moe_top_k * cfg.moe_capacity_factor
                  / cfg.moe_experts)
    return max(8, 8 * math.ceil(c / 8))


def _route(p, x, cfg, use="local"):
    """fp32 router logits (..., E), their softmax, and the top-k gates
    (renormalized, floor 1e-9) and expert ids (..., k); ``use``: the
    router's (``sharding.gather``)."""
    logits = sharding.dot(x.float(), p.router,
                          cast(p.router, torch.float32, use))
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[..., :cfg.moe_top_k], idx[..., :cfg.moe_top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate, idx


def _expert_w(w, x, cfg, use):
    """An expert weight as ``at_use`` casts it, as ``use`` takes it
    (``sharding.gather``: ``"whole"`` gathers it over ``model``,
    ``"local"`` is the rank's shard of the experts, ``"partial"`` all of a
    weight the rules replicate over ``model``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    return cast(w, cdt, use).to(torch.promote_types(x.dtype, cdt))


def _experts(p, h, cfg, eq_in, eq_out, use="whole"):
    """The batched expert FFN over the expert axis of ``h``."""
    a = torch.einsum(eq_in, h, _expert_w(p.wi, h, cfg, use))
    if cfg.mlp_type in GATES:
        g = torch.einsum(eq_in, h, _expert_w(p.wg, h, cfg, use))
        a = GATES[cfg.mlp_type](g) * a
    else:
        a = ACTIVATIONS[cfg.mlp_type](a)
    return torch.einsum(eq_out, a, _expert_w(p.wo, a, cfg, use))


def _z_loss(logits):
    return torch.logsumexp(logits, dim=-1).square().mean()


def moe_fwd_dense(p, x, cfg):
    """Exact (dropless) form: x (B, S, d) -> (y, aux)."""
    E = cfg.moe_experts
    logits, probs, gate, idx = _route(p, x, cfg)
    wmask = torch.zeros_like(probs).scatter(-1, idx, gate)
    eout = _experts(p, x, cfg, "bsd,edf->bsef", "bsef,efd->bsed")
    y = torch.einsum("bsed,bse->bsd", eout, at_use(wmask, eout, cfg))
    if cfg.moe_shared_expert:
        y = y + mlp_fwd(p.shared, x, cfg)
    density = (wmask > 0).float().mean((0, 1))
    lb = E * (density * probs.mean((0, 1))).sum()
    return y, {"moe_lb_loss": lb, "moe_z_loss": _z_loss(logits),
               "moe_drop_frac": torch.zeros((), device=x.device)}


def moe_fwd(p, x, cfg, n_groups: int = 0, sp=False):
    """x (B, S, d) -> (y (B, S, d), {"moe_lb_loss", "moe_z_loss",
    "moe_drop_frac"}): the dense form with ``cfg.moe_impl == "dense"``,
    else the capacity form over ``n_groups`` groups (default B, one a
    sequence), tagged ``moeffn`` for the cost counter as the reference's
    is. With ``sp`` x is the rank's chunk of the sequence, and so is y.
    The aux values are the whole step's on every rank."""
    if cfg.moe_impl != "dense":
        with cost.tag("moeffn"):
            return _moe_fwd_capacity(p, x, cfg, n_groups, sp)
    if sp:
        y, aux = moe_fwd_dense(p, sharding.gather_from_model(x, 1), cfg)
        return sharding.scatter_seq(y, reduce=False), aux
    return moe_fwd_dense(p, x, cfg)


def dispatch_slots(idx, E, C):
    """The capacity form's routing bookkeeping for expert ids ``idx`` (G, Ng,
    k): the choices flattened token-major (G, Ng·k), each one's rank among
    its expert's choices in that order (a stable argsort by expert, less
    the expert's exclusive offset), ``keep`` = rank < C, the slot
    ``expert·C + rank`` of a kept choice and E·C (a row past the buffer)
    of a dropped one, and each expert's count of choices (G, E)."""
    G = idx.shape[0]
    eid = idx.reshape(G, -1)
    n = eid.shape[1]
    order = torch.argsort(eid, dim=-1, stable=True)
    ranks = torch.empty_like(eid).scatter_(
        1, order, torch.arange(n, device=eid.device).expand(G, n))
    counts = torch.zeros((G, E), dtype=eid.dtype, device=eid.device)
    counts.scatter_add_(1, eid, torch.ones_like(eid))
    offsets = counts.cumsum(-1) - counts
    pos = ranks - offsets.gather(1, eid)
    keep = pos < C
    slot = torch.where(keep, eid * C + pos, torch.full_like(eid, E * C))
    return eid, keep, slot, counts


def _moe_fwd_capacity(p, x, cfg, n_groups=0, sp=False):
    B, S, d = x.shape
    G = n_groups or B
    t = sharding.tp()
    split = sharding.moe_split(cfg, G, cfg.moe_experts, cfg.moe_d_ff)
    if split.groups and not (sp and B % t.size):
        y, aux = _own_groups(p, x, cfg, G, sp, t)
    elif split.experts or split.f_data:
        y, aux = _own_experts(p, x, cfg, G, sp, split, t)
    else:
        if sp:
            x = sharding.gather_from_model(x, 1)
        y, aux = _routed(p, x.reshape(G, -1, d), cfg)
        y = y.reshape(x.shape)
        if cfg.moe_shared_expert:
            y = y + mlp_fwd(p.shared, x, cfg)
        return (sharding.scatter_seq(y, reduce=False) if sp else y), aux
    if cfg.moe_shared_expert:
        y = y + mlp_fwd(p.shared, x, cfg, sp)
    return y, aux


def _own_experts(p, x, cfg, G, sp, split, t):
    """Expert parallelism: every rank routes all of ``x``'s groups (under
    ``sp`` the gathered sequence) and computes its ``E / model`` experts
    (all of them without ``split.experts``), ``f / data`` of each with
    ``split.f_data``; the partial outputs summed over ``model`` (onto the
    rank's chunk under ``sp``)."""
    E = cfg.moe_experts
    xin = sharding.gather_seq(x) if sp else sharding.copy_to_model(x)
    n = E // t.size if split.experts else E
    lo = t.rank * n if split.experts else 0
    if split.experts and sharding.split_lo(p.wi, 0) != lo:
        raise ValueError("expert parallelism needs the experts stored by "
                         "the rules, sharded over model (shard_module)")
    y, aux = _routed(p, xin.reshape(G, -1, x.shape[-1]), cfg, (lo, n),
                     "partial" if split.experts else "local", "local",
                     split.f_data)
    y = y.reshape(xin.shape)
    if not split.experts:
        return y, aux
    y = sharding.scatter_seq(y) if sp else sharding.reduce_from_model(y)
    return y, {k: sharding.grad_once(v) for k, v in aux.items()}


def _own_groups(p, x, cfg, G, sp, t):
    """Groups over every rank: this ``model`` rank routes and computes its
    ``G / model`` groups, under ``sp`` its ``B / model`` rows gathered
    whole from every rank's chunk (an all-to-all) and handed back the
    same way, else its slice of ``x``'s groups, the outputs gathered over
    ``model``; the aux values are the mean of the ranks'."""
    B, S, d = x.shape
    m = t.size
    if sp:
        xs = sharding.all_to_all_model(x.reshape(m, B // m, S, d))
        xs = xs.transpose(0, 1).reshape(B // m, m * S, d)
    else:
        xs = sharding.copy_to_model(x).reshape(G, -1, d)[
            sharding.rank_slice(G)]
    y, aux = _routed(p, xs.reshape(G // m, -1, d), cfg, router="partial",
                     weights="partial")
    if sp:
        y = y.reshape(B // m, m, S, d).transpose(0, 1)
        y = sharding.all_to_all_model(y).reshape(B, S, d)
    else:
        y = sharding.gather_from_model(y, 0).reshape(B, S, d)
    means = sharding.reduce_from_model(torch.stack(
        [aux[k] for k in AUX_KEYS])) / m
    return y, dict(zip(AUX_KEYS, means.unbind()))


def _routed(p, tokens, cfg, experts=None, router="local", weights="whole",
            f_data=False):
    """The capacity form's routed half on ``tokens`` (G, Ng, d) -> (y (G,
    Ng, d), aux). ``experts``: (the first, the count) of the experts this
    rank computes, all by default: a choice of another rank's expert adds
    nothing to y. ``router``, ``weights``: the router's and the experts'
    use (``sharding.gather``; the experts' ``"local"`` is the rank's shard
    of them). ``f_data``: the experts are the rank's ``f`` slice, so the
    dispatch rows are gathered over ``data`` and ``wo``'s products summed
    over it."""
    G, Ng, d = tokens.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    lo, n = experts or (0, E)
    C = capacity(Ng, cfg)
    logits, probs, gate, idx = _route(p, tokens, cfg, router)
    eid, kept, slot, counts = dispatch_slots(idx, E, C)
    keep = kept
    if n != E:      # the choices of this rank's experts, slots from lo
        keep = kept & (eid >= lo) & (eid < lo + n)
        slot = torch.where(keep, slot - lo * C, torch.full_like(slot, n * C))

    # dispatch: each kept choice's token into its slot of (G, n·C, d); the
    # dropped ones (and another rank's) land in one extra row, sliced off
    src = tokens.repeat_interleave(k, dim=1).to(
        torch_dtype(cfg.compute_dtype))
    disp = src.new_zeros((G, n * C + 1, d)).scatter(
        1, slot[..., None].expand(-1, -1, d), src)[:, :n * C]
    disp = disp.reshape(G, n, C, d)
    if f_data:
        disp = sharding.rows_over_data(disp)
    eout = _experts(p, disp, cfg, "gecd,edf->gecf", "gecf,efd->gecd",
                    weights)
    if f_data:
        eout = sharding.own_rows(sharding.sum_over_data(eout), G)
    eout = eout.reshape(G, n * C, d)
    # combine: each choice gathers its slot back, times keep x gate
    safe = torch.where(keep, slot, torch.zeros_like(slot))
    back = eout.gather(1, safe[..., None].expand(-1, -1, d))
    back = back * at_use(keep[..., None] * gate.reshape(G, Ng * k, 1),
                         back, cfg)
    y = back.reshape(G, Ng, k, d).sum(2)

    # aux: Switch load balance over the routed fraction (dropped choices
    # included), router z-loss, the share of all the choices dropped
    density = counts.float() / Ng
    lb = E * (density * probs.mean(1)).sum(-1).mean()
    return y, {"moe_lb_loss": lb, "moe_z_loss": _z_loss(logits),
               "moe_drop_frac": 1.0 - kept.float().mean()}
