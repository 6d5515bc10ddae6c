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

On a mesh (``distributed.sharding.shard_module``) parameters, gradients and
moments are DTensors: the moments take their parameter's placements, the
update runs on each rank's local shard (``train_step``), and
``global_norm`` sums every element once across the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import is_dtensor


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
    """Zero moments in ``opt.moment_dtype`` beside each parameter (a
    DTensor parameter's with its placements), and a step count of 0."""
    mdt = getattr(torch, opt.moment_dtype)

    def zeros():
        return {n: torch.zeros_like(p, dtype=mdt, requires_grad=False)
                for n, p in params.items()}
    return {"m": zeros(), "v": zeros(), "count": 0}


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in fp32 (a 0-d tensor).
    With DTensor leaves each rank sums its local shards, one rank of each
    group of replicas counting a shard, and one all-reduce adds the ranks'
    sums, so every element counts once."""
    leaves = list(tree.values())
    sharded = [is_dtensor(x) for x in leaves]
    if not any(sharded):
        return torch.stack([x.float().square().sum()
                            for x in leaves]).sum().sqrt()
    if not all(sharded):
        raise TypeError("global_norm: DTensor and plain leaves mixed")
    total = torch.stack([_shard_square_sum(x) for x in leaves]).sum()
    if dist.get_world_size() > 1:      # one rank's sum is the whole
        dist.all_reduce(total)
    return total.sqrt()


def _shard_square_sum(x):
    """The local shard's sum of squares, or 0 on a rank that is not the
    first of its replicas (coordinate 0 on every mesh dim that replicates
    ``x``)."""
    s = x.to_local().float().square().sum()
    coord = x.device_mesh.get_coordinate()
    first = all(c == 0 for c, pl in zip(coord, x.placements)
                if pl.is_replicate())
    return s if first else torch.zeros_like(s)


def clip_scale(norm, max_norm):
    """The factor ``clip_by_global_norm`` scales every gradient by."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """Scale every gradient by min(1, max_norm / norm); returns (clipped
    gradients in their own dtypes, the norm before clipping)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in grads.items()}, norm


def is_matrix(p, rank):
    """Whether weight decay applies: a rank of 2 or more (``rank`` the
    reference layout's, else ``p``'s own)."""
    return (p.dim() if rank is None else rank) >= 2


def adamw_leaf(opt: OptConfig, count, lr):
    """AdamW's update of one leaf (or any piece of one) at step ``count``
    (1 on the first), bias-corrected by ``1 - b ** count``:
    ``update(g, m, v, p, matrix)`` returns (new p, m, v), each in its own
    dtype, computed in fp32; ``matrix`` adds the weight decay."""
    f32 = np.float32
    c1 = float(f32(1.0) - f32(opt.b1) ** f32(count))
    c2 = float(f32(1.0) - f32(opt.b2) ** f32(count))
    b1, b2 = opt.b1, opt.b2
    mdt = getattr(torch, opt.moment_dtype)

    def update(g, m, v, p, matrix):
        g = g.float()
        m = b1 * m.float() + (1 - b1) * g
        v = b2 * v.float() + (1 - b2) * g.square()
        step = (m / c1) / (torch.sqrt(v / c2) + opt.eps)
        if matrix:
            step = step + opt.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m.to(mdt), v.to(mdt)
    return update


def adamw_update(grads, opt_state, params, opt: OptConfig, lr, ranks=None):
    """One AdamW step (``adamw_leaf``) over every leaf. Returns (new params
    in their dtypes, new optimizer state); nothing is updated in place."""
    count = int(opt_state["count"]) + 1
    update = adamw_leaf(opt, count, lr)
    ranks = ranks or {}
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        new_p[n], new_m[n], new_v[n] = update(
            grads[n], opt_state["m"][n], opt_state["v"][n], p,
            is_matrix(p, ranks.get(n)))
    return new_p, {"m": new_m, "v": new_v, "count": count}
