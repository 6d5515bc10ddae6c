"""Feed-forward blocks: the gated SwiGLU / GeGLU and the ungated
squared-ReLU / GELU, weights cast to the compute dtype at use. The ungated
forms have no ``wg``, as the reference builds them. In a tensor-parallel
step (``distributed.sharding``) each rank computes its slice of ``d_ff``:
``wi`` / ``wg`` column-parallel, ``wo`` row-parallel and summed over
``model``. With the residual stream split over ``model`` (``sp``,
``sharding.seq_split``) the rank's chunk of the sequence is gathered before
``wi`` / ``wg`` (``gather_seq``) and ``wo``'s partial sums are
reduce-scattered back onto it (``scatter_seq``); where ``d_ff`` does not
split, the replicated weights compute on the chunk itself, their gradients
summed over ``model``. Serving on the serve rules' shards, each product
also multiplies its weight's ``"data2d"`` slice where it lies
(``sharding.dot``)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.models.common import ACTIVATIONS, at_use, torch_dtype, weight

GATES = {"swiglu": F.silu, "geglu": ACTIVATIONS["gelu"]}
UNGATED = ("relu2", "gelu")


class Mlp(nn.Module):
    def __init__(self, cfg, gen=None):
        super().__init__()
        if cfg.mlp_type not in GATES and cfg.mlp_type not in UNGATED:
            raise ValueError(f"mlp type {cfg.mlp_type!r} is not ported")
        d, f = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg.param_dtype)
        self.wi = weight(gen, (d, f), d, dt)
        if cfg.mlp_type in GATES:
            self.wg = weight(gen, (d, f), d, dt)
        self.wo = weight(gen, (f, d), f, dt)


def mlp_fwd(p, x, cfg, sp=False):
    """x (B,S,d) -> (B,S,d); with ``sp`` x is the rank's chunk of the
    sequence, and so is the output."""
    split = sharding.split_lo(p.wi, 1) is not None
    use = "partial" if sp and not split else "local"
    if split:
        x = sharding.gather_seq(x) if sp else sharding.copy_to_model(x)
    h = sharding.dot(x, p.wi, at_use(p.wi, x, cfg, use=use))
    if cfg.mlp_type in GATES:
        g = sharding.dot(x, p.wg, at_use(p.wg, x, cfg, use=use))
        h = GATES[cfg.mlp_type](g) * h
    else:
        h = ACTIVATIONS[cfg.mlp_type](h)
    y = sharding.dot(h, p.wo, at_use(p.wo, h, cfg, use=use))
    if not split:
        return y
    return sharding.scatter_seq(y) if sp else sharding.reduce_from_model(y)
