"""Gated feed-forward blocks (SwiGLU, GeGLU), weights cast to the compute
dtype at use."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import at_use, torch_dtype, weight

GATES = {"swiglu": F.silu,
         # jax.nn.gelu defaults to the tanh approximation
         "geglu": lambda g: F.gelu(g, approximate="tanh")}


class Mlp(nn.Module):
    def __init__(self, cfg, gen=None):
        super().__init__()
        if cfg.mlp_type not in GATES:
            raise ValueError(f"mlp type {cfg.mlp_type!r} is not ported")
        d, f = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg.param_dtype)
        self.wi = weight(gen, (d, f), d, dt)
        self.wg = weight(gen, (d, f), d, dt)
        self.wo = weight(gen, (f, d), f, dt)


def mlp_fwd(p, x, cfg):
    h = x @ at_use(p.wi, x, cfg)
    g = x @ at_use(p.wg, x, cfg)
    h = GATES[cfg.mlp_type](g) * h
    return h @ at_use(p.wo, h, cfg)
