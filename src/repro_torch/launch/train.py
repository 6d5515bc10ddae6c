"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 --batch 8 --seq 128 --ckpt-dir CKPT [--restore]
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --reduced --device cpu --steps 6 --batch 4 --seq 32
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh sim \
      --model 2 ...

Checkpoint/restart is automatic: ``--restore`` resumes from the newest
snapshot (training state + data cursor), which is the fault-tolerance path
— kill the process at any step and relaunch.

A port of the JAX package's ``repro.launch.train`` over the port's
``lm.init_lm``, ``optim`` (AdamW, schedules, ``make_train_step``),
``CheckpointManager`` and ``data.loader.Prefetcher``. Where it differs:

* It runs on ``--device`` (default ``cuda``); the step is eager
  (``torch.autograd``), nothing jitted; it updates the weights and moments
  in place, as the reference donates them to its jitted step.
* ``--mesh sim|single|multi`` builds the reference's meshes on a
  ``torch.distributed`` group (``launch.mesh``: a torchrun rendezvous from
  the environment, else one rank; NCCL on ``cuda``, gloo on ``cpu``):
  ``sim`` is (n / m, m) over ("data", "model") on the group's n ranks,
  ``m`` from ``--model`` (default 1), ``single`` / ``multi`` the
  production (16, 16) / (2, 16, 16) meshes. The parameters are stored
  sharded by the reference's rules; the step is tensor-parallel over
  ``model`` (heads, ff, lru and vocab split, ``distributed.sharding``) and
  each data-parallel rank trains on its rows of the one global batch, so
  a mesh run and ``--mesh none`` see the same tokens; only rank 0 logs
  and writes checkpoints. Where the config sets ``sequence_parallel`` the
  residual stream is split over ``model`` along the sequence, and
  attention whose heads do not divide ``model`` computes each rank's
  chunk of the queries (``sharding.seq_split``, ``context_parallel``).
  MoE layers split their capacity form as the reference's constraints
  do (``sharding.moe_split``): llama4's experts along E, each ``model``
  rank computing its shard of them; qwen3's groups over dp and ``model``
  where they divide both, the experts gathered whole over ``data``. A
  checkpoint restores across meshes, ``none`` included.
* Every arch of ``configs.registry.ARCH_IDS`` trains, the ``rwkv`` and
  ``rglru`` layers through their kernels' autograd Functions
  (``kernels.rwkv6.WKV6``: the scan kernel forward, its gradient kernel
  backward; ``kernels.rglru.RGLRU``: the scan kernel forward, its
  gradient kernel backward), each layer rematerialized as the config's
  ``remat`` says. Attention with a logit softcap raises before any
  weight is built: ``kernels.flash_attention.FlashAttention`` refuses
  it.
* The weights are drawn from seed 0 on the device, as the reference draws
  ``PRNGKey(0)``, so a card and the CPU start from other weights.
"""

from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.data.loader import Prefetcher
from repro_torch.data.synthetic import make_batch_iterator
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import (init_distributed, make_production_mesh,
                                     make_sim_mesh)
from repro_torch.models import lm
from repro_torch.models.common import trainable
from repro_torch.optim import OptConfig, init_opt_state, make_train_step


def check_trainable(cfg, mesh=None):
    """Raise what the port cannot train, before any weight is built.
    ``mesh`` is None or a DeviceMesh."""
    if mesh is not None and cfg.moe_experts and cfg.moe_impl == "dense" \
            and sharding.dp_size(mesh) > 1:
        raise NotImplementedError(
            f"{cfg.name}: the dense MoE form's load-balance loss is a "
            f"product of whole-batch means, which data-parallel ranks "
            f"cannot split; train the capacity form on a mesh")
    if cfg.attn_logit_softcap > 0:
        raise NotImplementedError(
            f"{cfg.name}: attention with logit softcap "
            f"{cfg.attn_logit_softcap} has no gradient (FlashAttention "
            f"refuses it)")


def build(cfg, opt, mesh=None, device="cuda"):
    """(trainable params on ``device``, stored sharded on ``mesh`` when one
    is given, AdamW state, the train step)."""
    check_trainable(cfg, mesh)
    dev = resolve_device(device)
    params = trainable(lm.init_lm(cfg, seed=0, device=dev))
    if mesh is not None:
        sharding.shard_module(params, mesh, cfg)
    opt_state = init_opt_state(dict(params.named_parameters()), opt)
    return params, opt_state, make_train_step(cfg, opt, mesh=mesh)


def state_placements(params, mesh):
    """The restore placements of ``{"params": ..., "opt": ...}``: each
    moment takes its parameter's."""
    if mesh is None:
        return None
    pl = {n: (mesh, list(p.placements)) for n, p in params.named_parameters()}
    return {"params": pl, "opt": {"m": pl, "v": pl}}


def train(cfg, opt, *, steps, batch, seq, ckpt_dir=None, restore=False,
          ckpt_every=50, mesh=None, log_every=10, seed=0, device="cuda"):
    """Train ``steps`` steps (from the newest checkpoint's step with
    ``restore``) on ``make_batch_iterator``'s batches. Returns (params,
    optimizer state, the losses of the steps this call ran)."""
    params, opt_state, step_fn = build(cfg, opt, mesh, device)
    dev = sharding.local(next(params.parameters())).device
    lead = mesh is None or dist.get_rank() == 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if restore and mgr is not None and mgr.latest_step() is not None:
        state, extra, start = mgr.restore(
            {"params": params, "opt": opt_state},
            placements=state_placements(params, mesh))
        # the manager rebuilds a module without gradients
        params = trainable(state["params"])
        opt_state = dict(state["opt"], count=int(state["opt"]["count"]))
        if lead:
            print(f"[train] restored step {start}")
    it = Prefetcher(make_batch_iterator(cfg, batch, seq, seed=seed,
                                        start_step=start))
    losses = []
    t0 = time.time()
    try:
        for i in range(start, steps):
            b = next(it)
            if mesh is not None:
                b = sharding.local_rows(b, mesh)
            b = {k: v.to(dev) for k, v in b.items()}
            params, opt_state, metrics = step_fn(params, opt_state, b)
            losses.append(float(metrics["loss"]))
            if lead and (i + 1) % log_every == 0:
                tok_s = batch * seq * log_every / (time.time() - t0)
                print(f"[train] step {i + 1} loss={losses[-1]:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"tok/s={tok_s:.0f}", flush=True)
                t0 = time.time()
            if mgr is not None and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, {"params": params, "opt": opt_state})
    finally:
        it.close()
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state}, block=True)
        mgr.wait()
        if mesh is not None:        # rank 0's files before any rank reads
            dist.barrier()
    return params, opt_state, losses


def make_mesh(kind, device="cuda", model=1):
    """The CLI's ``--mesh``: None for ``none``; else joins the process
    group (``launch.mesh.init_distributed``) and builds the reference's
    mesh of that name (``sim``: ``model`` ranks along "model")."""
    if kind == "none":
        return None
    _, world = init_distributed(device)
    if kind == "sim":
        if world % model:
            raise ValueError(f"--model {model} does not divide the group's "
                             f"{world} ranks")
        return make_sim_mesh(world, (world // model, model),
                             ("data", "model"))
    return make_production_mesh(multi_pod=kind == "multi")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "sim", "single", "multi"])
    ap.add_argument("--model", type=int, default=1,
                    help="ranks along the model axis of --mesh sim")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    total_steps=args.steps, microbatches=args.microbatches)
    mesh = make_mesh(args.mesh, args.device, args.model)
    _, _, losses = train(cfg, opt, steps=args.steps, batch=args.batch,
                         seq=args.seq, ckpt_dir=args.ckpt_dir,
                         restore=args.restore, mesh=mesh,
                         device=args.device)
    if mesh is not None and dist.get_rank() != 0:
        return
    if losses:
        print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"[train] done: nothing to run past step {args.steps}")


if __name__ == "__main__":
    main()
