#!/usr/bin/env python3
"""Which collectives gloo completes for CUDA tensors, four ranks on one card.

  python3 tools/gloo_cuda_probe.py [--cpu] [--ranks N] [--timeout S]

One card holds several ranks only over gloo (NCCL refuses two ranks on one
device), and gloo stages CUDA tensors through the host; ``chip_smoke.py``
phase 12 and ``distributed/sharding.py`` use only what this probe finds
working. Each rank joins a gloo group on a free localhost port with the
card as its device and runs, in order, printing each result as it comes:
``all_reduce`` (sum, max) in ``torch.distributed`` and in its functional
form, a DTensor gathered over a one-rank "data" axis of a (1, N) mesh and
a gradient summed over "model" (the tensor-parallel step's two
redistributions), the time of a 32 MB functional all-reduce, the
all-to-alls (functional and c10d ``all_to_all_single``, each checked for
the blocks it should deliver) and the time of a 32 MB one, then the
all-gathers, the reduce-scatter and the broadcast (after the all-to-alls:
a collective that never completes stops every step after it). A rank that
does not finish in ``--timeout`` seconds is reported with the last
operation it completed and stopped. ``--cpu`` runs the same on CPU
tensors.
"""

from __future__ import annotations

import argparse
import multiprocessing
import queue
import socket
import time

STEPS = ("all_reduce sum", "all_reduce max", "functional all_reduce sum",
         "functional all_reduce max", "dtensor gather over data",
         "dtensor gradient summed over model", "32 MB all_reduce ms",
         "functional all_to_all_single", "all_to_all_single",
         "32 MB all_to_all_single ms",
         "functional all_gather", "all_gather_into_tensor", "all_gather",
         "functional reduce_scatter", "broadcast")


def run_step(name, torch, dist, funcol, dev, ranks):
    x = torch.full((8,), float(dist.get_rank() + 1), device=dev)

    def wait(t):
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t
    if name.startswith("all_reduce"):
        t = x.clone()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, name.split()[1].upper()))
        return float(t[0])
    if name.startswith("functional all_reduce"):
        return float(wait(funcol.all_reduce(x, name.split()[-1],
                                            dist.group.WORLD))[0])
    if name.startswith("dtensor"):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Partial, Replicate, Shard,
                                              distribute_tensor)
        mesh = init_device_mesh(dev, (1, ranks),
                                mesh_dim_names=("data", "model"))
        local = name.endswith("data")
        pl = [Shard(0), Shard(1)] if local else [Shard(0), Replicate()]
        w = torch.nn.Parameter(distribute_tensor(
            torch.ones(8, 8, device=dev), mesh, pl, src_data_rank=None))
        target = [Replicate(), Shard(1)] if local else [Replicate()] * 2
        grads = [Partial(), Shard(1)] if local else [Partial()] * 2
        out = w.redistribute(mesh, target).to_local(grad_placements=grads)
        out.sum().backward()
        return float(w.grad.to_local()[0, 0])
    if name.startswith("32 MB"):
        big = torch.ones(8 << 20, device=dev)
        if "all_reduce" in name:
            def op():
                return wait(funcol.all_reduce(big, "sum", dist.group.WORLD))
        else:
            def op():
                return wait(funcol.all_to_all_single(big, None, None,
                                                     dist.group.WORLD))
        op()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(5):
            op()
        if dev == "cuda":
            torch.cuda.synchronize()
        return round((time.perf_counter() - t) / 5 * 1e3, 1)
    if name == "functional all_gather":
        return tuple(wait(funcol.all_gather_tensor(x, 0,
                                                   dist.group.WORLD)).shape)
    if name == "all_gather_into_tensor":
        out = torch.empty(8 * ranks, device=dev)
        dist.all_gather_into_tensor(out, x)
        return float(out.sum())
    if name == "all_gather":
        outs = [torch.empty(8, device=dev) for _ in range(ranks)]
        dist.all_gather(outs, x)
        return float(sum(o.sum() for o in outs))
    if name == "functional reduce_scatter":
        return tuple(wait(funcol.reduce_scatter_tensor(
            torch.ones(8 * ranks, device=dev), "sum", 0,
            dist.group.WORLD)).shape)
    if name.endswith("all_to_all_single"):
        # block j of each rank's (ranks, 2) input goes to rank j: rank r
        # receives (i + 1) * 100 + r from each rank i
        src = (torch.arange(ranks, device=dev, dtype=torch.float32)[:, None]
               + 100.0 * (dist.get_rank() + 1)).expand(ranks, 2).contiguous()
        if name.startswith("functional"):
            out = wait(funcol.all_to_all_single(src, None, None,
                                                dist.group.WORLD))
        else:
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src)
        want = (100.0 * torch.arange(1, ranks + 1, device=dev)
                + dist.get_rank())[:, None].expand(ranks, 2)
        return f"exact {bool(torch.equal(out, want))}"
    t = x.clone()
    dist.broadcast(t, 0)
    return float(t[0])


def rank_main(rank, ranks, port, dev, results):
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=ranks)
    for name in STEPS:
        try:
            out = f"ok {run_step(name, torch, dist, funcol, dev, ranks)}"
        except Exception as e:                  # reported, then go on
            out = f"FAIL {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        if dev == "cuda":
            torch.cuda.synchronize()
        results.put((rank, name, out))
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    import torch
    dev = "cpu" if args.cpu else "cuda"
    if dev == "cuda" and not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device (--cpu probes CPU tensors)")
        return 2
    print(f"torch {torch.__version__}, {args.ranks} gloo ranks, {dev} "
          f"tensors" + (f" on {torch.cuda.get_device_name(0)}"
                        if dev == "cuda" else ""), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=rank_main, daemon=True,
                         args=(r, args.ranks, port, dev, results))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    done = {r: [] for r in range(args.ranks)}
    deadline = time.perf_counter() + args.timeout
    while any(len(v) < len(STEPS) for v in done.values()):
        try:
            rank, name, out = results.get(timeout=max(
                0.1, deadline - time.perf_counter()))
        except queue.Empty:
            break
        done[rank].append(name)
        print(f"rank {rank}: {name}: {out}", flush=True)
    stuck = {r: (v[-1] if v else "init") for r, v in done.items()
             if len(v) < len(STEPS)}
    for r, last in sorted(stuck.items()):
        nxt = STEPS[len(done[r])]
        print(f"rank {r}: {nxt}: no result in {args.timeout} s (last done: "
              f"{last})", flush=True)
    for p in procs:
        p.join(0 if stuck else 30)
        if p.is_alive():
            p.terminate()
            p.join(10)
    return 1 if stuck else 0


if __name__ == "__main__":
    raise SystemExit(main())
