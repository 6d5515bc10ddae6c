"""AdamW with a configurable moment dtype (bf16 moments halve the
optimizer's memory) and global-norm clipping. A port of the JAX package's
``repro.optim.optimizers``.

Parameters, gradients and moments are flat ``{name: tensor}`` dicts keyed
by a module's ``named_parameters()`` names; the optimizer state is
``{"m": {...}, "v": {...}, "count": int}``, its moments beside the
parameters on their devices.

Weight decay goes to "matrices" only, and a matrix is a leaf of rank 2 or
more *in the reference's layout*, where every layer leaf is stacked on a
leading ``repeats`` axis: a layer's norm scale (d,) is a (repeats, d)
leaf there and is decayed, the final norm's scale (d,) is not. ``ranks``
(``bridge.ref_ndims``) carries those ranks; without it a tensor's own rank
decides.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"        # cosine | linear | constant
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16
    microbatches: int = 1           # gradient-accumulation steps
    z_loss: float = 0.0


def init_opt_state(params, opt: OptConfig):
    """Zero moments in ``opt.moment_dtype`` beside each parameter, and a
    step count of 0."""
    mdt = getattr(torch, opt.moment_dtype)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
                for n, p in params.items()}
    return {"m": zeros(), "v": zeros(), "count": 0}


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in fp32 (a 0-d tensor)."""
    leaves = [x.float().square().sum() for x in tree.values()]
    return torch.stack(leaves).sum().sqrt()


def clip_by_global_norm(grads, max_norm):
    """Scale every gradient by min(1, max_norm / norm); returns (clipped
    gradients in their own dtypes, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in grads.items()}, norm


def _is_matrix(p, rank):
    return (p.dim() if rank is None else rank) >= 2


def adamw_update(grads, opt_state, params, opt: OptConfig, lr, ranks=None):
    """One AdamW step in fp32, bias-corrected by ``1 - b ** count``.
    Returns (new params in their dtypes, new optimizer state); nothing is
    updated in place."""
    count = int(opt_state["count"]) + 1
    f32 = np.float32
    c1 = float(f32(1.0) - f32(opt.b1) ** f32(count))
    c2 = float(f32(1.0) - f32(opt.b2) ** f32(count))
    b1, b2 = opt.b1, opt.b2
    mdt = getattr(torch, opt.moment_dtype)
    ranks = ranks or {}
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        g = grads[n].float()
        m = b1 * opt_state["m"][n].float() + (1 - b1) * g
        v = b2 * opt_state["v"][n].float() + (1 - b2) * g.square()
        step = (m / c1) / (torch.sqrt(v / c2) + opt.eps)
        if _is_matrix(p, ranks.get(n)):
            step = step + opt.weight_decay * p.float()
        new_p[n] = (p.float() - lr * step).to(p.dtype)
        new_m[n], new_v[n] = m.to(mdt), v.to(mdt)
    return new_p, {"m": new_m, "v": new_v, "count": count}
