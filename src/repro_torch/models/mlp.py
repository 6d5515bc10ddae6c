"""SwiGLU feed-forward block, weights cast to the compute dtype at use."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import torch_dtype, weight


class Mlp(nn.Module):
    def __init__(self, cfg, gen=None):
        super().__init__()
        if cfg.mlp_type != "swiglu":
            raise ValueError(f"mlp type {cfg.mlp_type!r} is not ported")
        d, f = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg.param_dtype)
        self.wi = weight(gen, (d, f), d, dt)
        self.wg = weight(gen, (d, f), d, dt)
        self.wo = weight(gen, (f, d), f, dt)


def mlp_fwd(p, x, cfg):
    cdt = torch_dtype(cfg.compute_dtype)
    h = x @ p.wi.to(cdt)
    g = x @ p.wg.to(cdt)
    return (F.silu(g) * h) @ p.wo.to(cdt)
