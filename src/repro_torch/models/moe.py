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
The reference's sharding constraints have nothing to constrain here: on a
mesh the experts are gathered whole at use and every ``model`` rank
computes all of them on its rows, in training and in serving alike (expert
parallelism is ROADMAP Queue 1 item 3). Under sequence parallelism
(``sp``) the rank's chunk of the sequence is gathered first
(``gather_from_model``), so routing, capacity and the aux values see every
token as without it, and the rank keeps its chunk of the output
(``scatter_seq`` without a sum: every rank computes the same FFN, and the
gradient's chunks are gathered for it). In a serve step that gather is the
one weight gather left: the serve rules store the experts over ``data``
too, where the dense products multiply their slices in place
(``sharding.dot``: the router's, the shared expert's MLP, which is
tensor-parallel over ``d_ff``, ``mlp.mlp_fwd``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.distributed import cost, sharding
from repro_torch.models.common import (ACTIVATIONS, at_use, cast,
                                       torch_dtype, weight)
from repro_torch.models.mlp import GATES, Mlp, mlp_fwd

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


class Moe(nn.Module):
    """``router`` (d, E) fp32; ``wg``, ``wi`` (E, d, f) and ``wo`` (E, f, d)
    in the param dtype (``wg`` whatever the MLP type, as the reference
    builds it); ``shared``, an ``Mlp`` of width ``d_ff``, with
    ``moe_shared_expert``."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        d, E, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
        dt = torch_dtype(cfg.param_dtype)
        self.router = weight(gen, (d, E), d, torch.float32)
        self.wg = weight(gen, (E, d, f), d, dt)
        self.wi = weight(gen, (E, d, f), d, dt)
        self.wo = weight(gen, (E, f, d), f, dt)
        if cfg.moe_shared_expert:
            self.shared = Mlp(cfg, gen)


def capacity(n_group_tokens: int, cfg) -> int:
    """Slots an expert takes a group: ceil(tokens x top_k x capacity
    factor / experts), rounded up to a multiple of 8 and at least 8."""
    c = math.ceil(n_group_tokens * cfg.moe_top_k * cfg.moe_capacity_factor
                  / cfg.moe_experts)
    return max(8, 8 * math.ceil(c / 8))


def _route(p, x, cfg):
    """fp32 router logits (..., E), their softmax, and the top-k gates
    (renormalized, floor 1e-9) and expert ids (..., k)."""
    logits = sharding.dot(x.float(), p.router, cast(p.router, torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[..., :cfg.moe_top_k], idx[..., :cfg.moe_top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate, idx


def _expert_w(w, x, cfg):
    """An expert weight as ``at_use`` casts it, gathered whole over
    ``model`` (``sharding.gather``'s ``use="whole"``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    return cast(w, cdt, "whole").to(torch.promote_types(x.dtype, cdt))


def _experts(p, h, cfg, eq_in, eq_out):
    """The batched expert FFN over the expert axis of ``h``."""
    a = torch.einsum(eq_in, h, _expert_w(p.wi, h, cfg))
    if cfg.mlp_type in GATES:
        g = torch.einsum(eq_in, h, _expert_w(p.wg, h, cfg))
        a = GATES[cfg.mlp_type](g) * a
    else:
        a = ACTIVATIONS[cfg.mlp_type](a)
    return torch.einsum(eq_out, a, _expert_w(p.wo, a, cfg))


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
    is. With ``sp`` x is the rank's chunk of the sequence, and so is y."""
    if sp:
        y, aux = moe_fwd(p, sharding.gather_from_model(x, 1), cfg, n_groups)
        return sharding.scatter_seq(y, reduce=False), aux
    if cfg.moe_impl == "dense":
        return moe_fwd_dense(p, x, cfg)
    with cost.tag("moeffn"):
        return _moe_fwd_capacity(p, x, cfg, n_groups)


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


def _moe_fwd_capacity(p, x, cfg, n_groups=0):
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    G = n_groups or B
    tokens = x.reshape(G, (B * S) // G, d)
    Ng = tokens.shape[1]
    C = capacity(Ng, cfg)
    logits, probs, gate, idx = _route(p, tokens, cfg)
    _, keep, slot, counts = dispatch_slots(idx, E, C)

    # dispatch: each kept choice's token into its slot of (G, E·C, d); the
    # dropped ones land in one extra row, which is sliced off
    src = tokens.repeat_interleave(k, dim=1).to(
        torch_dtype(cfg.compute_dtype))
    disp = src.new_zeros((G, E * C + 1, d)).scatter(
        1, slot[..., None].expand(-1, -1, d), src)[:, :E * C]
    eout = _experts(p, disp.reshape(G, E, C, d), cfg, "gecd,edf->gecf",
                    "gecf,efd->gecd").reshape(G, E * C, d)
    # combine: each choice gathers its slot back, times keep x gate
    safe = torch.where(keep, slot, torch.zeros_like(slot))
    back = eout.gather(1, safe[..., None].expand(-1, -1, d))
    back = back * at_use(keep[..., None] * gate.reshape(G, Ng * k, 1),
                         back, cfg)
    y = back.reshape(G, Ng, k, d).sum(2).reshape(B, S, d)
    if cfg.moe_shared_expert:
        y = y + mlp_fwd(p.shared, x, cfg)

    # aux: Switch load balance over the routed fraction (dropped choices
    # included), router z-loss, the share of choices dropped
    density = counts.float() / Ng
    lb = E * (density * probs.mean(1)).sum(-1).mean()
    return y, {"moe_lb_loss": lb, "moe_z_loss": _z_loss(logits),
               "moe_drop_frac": 1.0 - keep.float().mean()}
