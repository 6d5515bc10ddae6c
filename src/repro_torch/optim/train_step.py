"""Train-step factory: gradients by ``torch.autograd.grad``, optional
gradient-accumulation microbatching, clipping, the schedule and AdamW (a
port of the JAX package's ``repro.optim.train_step``).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

``params`` is a module whose parameters require grad (``models.common.
trainable``); the step writes the updated values into it and returns it.
``batch`` is a dict of tensors with a leading batch axis. Microbatching
reshapes that axis to (n, B/n, ...) and sums the fp32 gradients g/n in
order, as the reference's ``lax.scan`` does; the metrics are averaged.

Data parallel: with ``replicas`` (one module a device, each holding
``params``' values; ``params`` itself may be the first), ``batch`` is a
list of as many shards. Each replica takes its shard's gradients; they
are summed on ``params``' device before the single update, and so are the
metrics (a shard's loss normalized by sums over the whole batch makes the
sum the whole batch's loss). After the update every replica takes the
new values.

On a mesh (``mesh``, the parameters DTensors from
``distributed.sharding.shard_module``) ``batch`` is this rank's rows of the
global batch (``sharding.local_rows``) and the step is tensor-parallel over
``model``: the loss and its gradients run inside
``sharding.activation_sharding(mesh, cfg, "train")``, where each rank
computes its ``model`` shard of the layers (``sharding.gather``,
``copy_to_model``, ``reduce_from_model``). Every rank along ``model`` then
holds the same loss of its dp shard's rows, and each leaf's gradient is
already the whole gradient of that rank's part of it (a ``model``-sharded
leaf's shard; a replicated leaf, the same on every ``model`` rank, or
summed over ``model`` where each rank used its own slice of it), so only
the dp ranks' gradients are summed (``gather``'s backward) and each rank's
loss is divided by the dp size: the sum is ``sum_dp g_r / dp = mean_dp
g_r``, the gradient of the global batch's mean loss, whenever each rank's
loss is the mean over its rows of per-row (per-group) terms of equal
weight (the CE over ``lm_batch``'s unmasked targets, the MoE capacity
form's aux terms). The metrics are all-reduced to their global means;
clipping takes the norm across ranks (``optimizers.global_norm``, one rank
of each group of replicas counting a shard); AdamW runs on each rank's
local shards, so a replicated leaf gets the same gradient on every rank and
stays bitwise equal across them.

The step writes the new parameters and moments into ``params`` and
``opt_state``'s moment tensors, as the reference's launcher donates both
to its jitted step, and updates a leaf in flat slices of ``UPDATE_SLICE``
elements: past the gradients, the update holds one slice's fp32
temporaries, not a second copy of the weights, gradients and moments.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (activation_sharding, dp_size,
                                              local)
from repro_torch.models import lm
from repro_torch.optim.optimizers import (OptConfig, adamw_leaf,
                                          clip_scale, global_norm, is_matrix)
from repro_torch.optim.schedules import make_schedule

UPDATE_SLICE = 1 << 26      # elements of a leaf the update takes at a time


def _trained(module):
    return [(n, p) for n, p in module.named_parameters() if p.requires_grad]


def make_train_step(cfg, opt: OptConfig, loss_fn=None, mesh=None):
    from repro_torch.bridge import ref_ndims
    schedule = make_schedule(opt)
    loss_fn = loss_fn or (lambda p, b: lm.lm_loss(p, b, cfg))
    ranks_in_mesh = 1 if mesh is None else mesh.size()

    def grads_of(module, batch):
        if mesh is None:
            return module_grads(module, batch, 1)
        with activation_sharding(mesh, cfg, "train"):
            return module_grads(module, batch, dp_size(mesh))

    def module_grads(module, batch, dp):
        named = _trained(module)
        loss, metrics = loss_fn(module, batch)
        grads = torch.autograd.grad(loss / dp if dp > 1 else loss,
                                    [p for _, p in named], allow_unused=True)
        # a parameter the loss does not reach gets zeros, as in JAX
        return ({n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named, grads)},
                {k: v.detach() for k, v in metrics.items()})

    def shard_grads(module, batch):
        if opt.microbatches <= 1:
            return grads_of(module, batch)
        n = opt.microbatches
        mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
              for k, v in batch.items()}
        acc = {name: torch.zeros_like(p, dtype=torch.float32,
                                      requires_grad=False)
               for name, p in _trained(module)}
        ms = []
        for i in range(n):
            g, m = grads_of(module, {k: v[i] for k, v in mb.items()})
            acc = {name: a + g[name].float() / n for name, a in acc.items()}
            ms.append(m)
        return acc, {k: torch.stack([m[k] for m in ms]).mean()
                     for k in ms[0]}

    def train_step(params, opt_state, batch, replicas=None):
        dev = next(params.parameters()).device
        grads = metrics = None
        for module, shard in ([(params, batch)] if replicas is None
                              else zip(replicas, batch)):
            g, m = shard_grads(module, shard)
            if grads is None:
                grads = {k: v.to(dev) for k, v in g.items()}
                metrics = {k: v.to(dev) for k, v in m.items()}
            else:
                grads = {k: v + g[k].to(dev) for k, v in grads.items()}
                metrics = {k: v + m[k].to(dev) for k, v in metrics.items()}
        if mesh is not None:
            metrics = _global_means(metrics, ranks_in_mesh)
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, opt.clip_norm)
        lr = schedule(opt_state["count"])
        count = int(opt_state["count"]) + 1
        update = adamw_leaf(opt, count, lr)
        ranks = ref_ndims(params)
        m, v = opt_state["m"], opt_state["v"]
        with torch.no_grad():
            for n, p in _trained(params):
                g = local(grads.pop(n)).reshape(-1)
                flat = [local(x).view(-1) for x in (p, m[n], v[n])]
                for i in range(0, g.numel(), UPDATE_SLICE):
                    pieces = [x[i:i + UPDATE_SLICE] for x in flat]
                    gi = g[i:i + UPDATE_SLICE]
                    new = update((gi.float() * scale).to(gi.dtype),
                                 pieces[1], pieces[2], pieces[0],
                                 is_matrix(p, ranks.get(n)))
                    for x, y in zip(pieces, new):
                        x.copy_(y)
            for r in replicas or ():
                if r is not params:
                    for (_, a), (_, b) in zip(_trained(r), _trained(params)):
                        a.copy_(b)
        opt_state = {"m": m, "v": v, "count": count}
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def _global_means(metrics, n):
    """Each 0-d metric averaged over the mesh's ``n`` ranks (one
    all-reduce)."""
    keys = sorted(metrics)
    total = torch.stack([metrics[k].float() for k in keys])
    if n > 1:
        dist.all_reduce(total)
    return dict(zip(keys, total / n))
