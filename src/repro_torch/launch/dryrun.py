"""Multi-pod dry run: count every (arch x shape x mesh) cell's step on the
``meta`` device and extract its roofline terms (the counterpart of the JAX
package's ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # a process a cell

The reference lowers and compiles each cell for 256 or 512 placeholder devices
and walks the compiled HLO. The port has no compiler: this process joins a fake
process group of 256 or 512 ranks (``FakeStore``: collectives are accepted and
move nothing) as one rank, builds the config's parameters on ``meta``, stores
them as DTensors by ``param_spec_tree`` (serve mode for decode shapes, as the
reference's), and runs the train step, prefill or decode step once in
``activation_sharding`` of the same mode under ``distributed.cost``'s counter:
one rank's local ops, the kernels by their formulas, the collectives its
DTensors and layers issue. The rank is the last along ``model`` (of the first
``data`` row): every rank does the same work but flash's under context
parallelism, whose causal chunk is that rank's last and longest, the one a step
waits for. Nothing is allocated and nothing needs a card.

What the counts say: every cell computes as the reference shards it,
tensor-parallel over ``model`` (``distributed.sharding``). A train cell's step
and a prefill cell (forward only) store the parameters by the train rules and
gather them over ``data`` only: each rank computes its heads, ff, lru and vocab
slice (the kernels at their local shapes), with the all-reduces of the
row-parallel products (and in training of the column-parallel products'
gradients) counted by kind; a prefill writes the rank's shard of each cache and
leaves the logits split over the vocab. A train cell whose config sets
``sequence_parallel`` splits the residual stream over ``model`` (the norms and
residual adds on S / 16 positions a rank; an all-gather before each
column-parallel block and a reduce-scatter after each row-parallel one, both
made of all-reduces, so they count as all-reduces, at twice the bytes of the
NCCL forms); where the heads do not divide ``model`` (smollm 15, whisper 12,
recurrentgemma 10, llava 56 against 16) attention computes the rank's chunk of
the query sequence (context parallelism), flash counted at the chunk's length
and offset, in a train cell and a prefill cell alike. A decode cell
(``decode_32k``, ``long_500k``) stores them by the serve rules, whose
would-be-FSDP dim lies over ``data`` as a second tensor axis (``"data2d"``):
the weights stay where they are and the token rows move (``sharding.dot``: two
all-reduces a product over ``data``), so a dense decode step gathers no weight;
its caches are the rank's shards as ``cache_spec_tree`` places them (batch over
``data``, KV heads over ``model``, or the head dim where the heads do not
divide, gathered over ``model`` before flash). The MoE cells compute as the
reference splits them (``sharding.moe_split``): llama4's experts stay on their
``model`` rank (each rank its 8 of 128, in training gathered over ``data``
only; in a decode cell also on their ``f`` slice over ``data``, the dispatch
rows gathered over ``data`` and ``wo``'s products summed over it), the partial
outputs summed over ``model``; qwen3's groups split over every rank in a train
and a prefill cell (under sequence parallelism an all-to-all hands each rank
its rows and hands them back), its experts on ``model`` in a decode cell,
whose 128 groups stay on ``data``. The bytes are eager PyTorch's (no fusion:
every op's operands and result).
``memory_analysis`` gives the arguments a rank holds (parameters, AdamW
moments and its batch rows, or its cache shards); temp bytes are null,
since no compiler plans the step's buffers.

``--attn-impl`` is left out: the port has one attention path, the flash
kernel (its formula here), where the reference can pick its naive XLA
baseline. ``--override`` stays.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, ShapeConfig,
                                 get_config, get_reduced, shape_applicable)
from repro_torch.distributed import cost
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.roofline import Roofline
from repro_torch.models import lm
from repro_torch.models.common import trainable
from repro_torch.optim import OptConfig, init_opt_state, make_train_step

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _nbytes(tensors):
    return int(sum(shd.local(t).numel() * t.element_size() for t in tensors))


def batch_struct(cfg, B, S, kind):
    """The rank's batch on ``meta``: int32 tokens (and targets in
    training), the frontend stub where the arch takes one."""
    meta = dict(device="meta")
    batch = {"inputs": torch.empty(B, S, dtype=torch.int32, **meta)}
    if kind == "train":
        batch["targets"] = torch.empty(B, S, dtype=torch.int32, **meta)
    if cfg.frontend in ("vision_patches", "audio_frames"):
        batch["patches" if cfg.frontend == "vision_patches" else "frames"] = \
            torch.empty(B, cfg.frontend_seq, cfg.d_model, **meta)
    return batch


def decode_caches(cfg, rows, length, mesh):
    """A decode cell's caches on ``meta``: each layer's as a prefill leaves
    it (a ``dec_attn`` layer's self cache beside its encoder's cross K/V
    over ``cfg.frontend_seq`` frames, which the reference allocates with
    the self cache), the rank's shard as ``cache_spec_tree`` places it."""
    from repro_torch.models import blocks
    out = []
    for kind in cfg.layer_kinds:
        cache = blocks.init_layer_cache(kind, cfg, rows, length,
                                        device="meta")
        if kind == "dec_attn":
            kv = (rows, cfg.frontend_seq, cfg.n_kv_heads, cfg.head_dim)
            cache = {"self": cache, "cross": {
                n: torch.empty(kv, dtype=cache["k"].dtype, device="meta")
                for n in ("k", "v")}}
        out.append(shd.local_cache(cache, kind, mesh, cfg, rows, "meta"))
    return out


def step_of(cfg, sc, mesh, params):
    """(the cell's step as a thunk, the arguments a rank holds, tokens)."""
    rows = sc.global_batch
    if shd.tokens_sharding(mesh, (rows,)):
        rows //= shd.dp_size(mesh)
    if sc.kind == "train":
        # bf16-param archs (400B class) also store bf16 optimizer moments
        opt = OptConfig(microbatches=cfg.train_microbatches,
                        moment_dtype=("bfloat16"
                                      if cfg.param_dtype == "bfloat16"
                                      else "float32"))
        state = init_opt_state(dict(params.named_parameters()), opt)
        batch = batch_struct(cfg, rows, sc.seq_len, "train")
        step = make_train_step(cfg, opt, mesh=mesh)
        held = list(state["m"].values()) + list(state["v"].values())
        return (lambda: step(params, state, batch),
                held + list(batch.values()), sc.global_batch * sc.seq_len)
    if sc.kind == "prefill":
        batch = batch_struct(cfg, rows, sc.seq_len, "prefill")

        def fn():
            with torch.no_grad():
                lm.prefill(params, batch, cfg, cache_len=sc.seq_len)
        return fn, list(batch.values()), sc.global_batch * sc.seq_len
    # decode: one new token against a cache / state of length S
    caches = decode_caches(cfg, rows, sc.seq_len, mesh)
    token = torch.empty(rows, 1, dtype=torch.int32, device="meta")

    def fn():
        with torch.no_grad():
            lm.decode_step(params, caches, token, sc.seq_len - 1, cfg)
    held = [t for c in caches for _, t in shd._leaves(c)] + [token]
    return fn, held, sc.global_batch


def run_cell(arch, shape, mesh_kind, overrides=None, *, reduced=False,
             rank=None):
    """One cell's record. ``shape``: a name of ``SHAPES_BY_NAME`` or a
    ``ShapeConfig``; ``mesh_kind``: "single", "multi", or a (data, model)
    shape for a small fake mesh; ``reduced`` takes the arch's reduced
    config (the tests' size); ``rank`` the fake group's rank counted
    (default: the last along ``model`` of the first ``data`` row)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    sc = shape if isinstance(shape, ShapeConfig) else SHAPES_BY_NAME[shape]
    ok, why = shape_applicable(cfg, sc)
    rec = {"arch": arch, "shape": sc.name, "mesh": str(mesh_kind),
           "applicable": ok, "skip_reason": why,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    if not ok:
        return rec
    dims, axes = MESHES.get(mesh_kind, (tuple(mesh_kind), ("data", "model")))
    chips = int(np.prod(dims))
    rank = dims[-1] - 1 if rank is None else rank
    if dist.is_initialized():
        raise RuntimeError("run_cell joins a fake process group of its own; "
                           "one is already up")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=chips)
    try:
        t0 = time.time()
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
        with torch.device("meta"):
            params = lm.LM(cfg)
        mode = "serve" if sc.kind == "decode" else "train"
        if sc.kind == "train":
            params = trainable(params)
        shd.shard_module(params, mesh, cfg, mode)
        fn, held, tokens = step_of(cfg, sc, mesh, params)
        split_rows = bool(shd.tokens_sharding(mesh, (sc.global_batch,)))
        with shd.activation_sharding(mesh, cfg, mode, split_rows), \
                cost.counting() as counter:
            fn()
        t_count = time.time() - t0
    finally:
        dist.destroy_process_group()
    total = counter.total
    attn = counter.select(r"flashattn|sdpattn")
    mix = counter.select(r"wkvscan|rgscan|moeffn")
    roof = Roofline(
        flops_per_device=total.flops, hbm_bytes_per_device=total.bytes,
        collective_bytes_per_device=total.coll_total, chips=chips,
        model_flops=cost.model_flops(cfg, sc.kind, tokens),
        collectives={k: round(v) for k, v in total.coll.items() if v})
    param_bytes = _nbytes(params.parameters())
    rec.update({
        "chips": chips,
        "rank": rank,
        "count_s": round(t_count, 2),
        "memory_analysis": {
            "argument_size_bytes": param_bytes + _nbytes(held),
            "parameter_bytes": param_bytes,
            "temp_size_bytes": None,
            "temp_size_reason": "no compiler plans the eager step's buffers",
        },
        "roofline": roof.to_dict(),
        "attn_tagged": {"flops": attn.flops, "bytes": attn.bytes},
        "mixer_tagged": {"flops": mix.flops, "bytes": mix.bytes},
    })
    return rec


def roofline_line(rec):
    """The record's one-line summary."""
    if not rec.get("applicable") or "roofline" not in rec:
        return (f"{rec['arch']} {rec['shape']} {rec['mesh']}: SKIP — "
                f"{rec.get('skip_reason')}")
    r = rec["roofline"]
    return (f"{rec['arch']} {rec['shape']} {rec['mesh']}: chips="
            f"{rec['chips']} count={rec['count_s']}s "
            f"t_comp={r['t_compute_s']:.4f}s t_mem={r['t_memory_s']:.4f}s "
            f"t_coll={r['t_collective_s']:.4f}s bottleneck={r['bottleneck']} "
            f"mfr={r['model_flops_ratio']:.3f} "
            f"roofline_frac={r['roofline_fraction']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig field overrides")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cells = [(a, s, m) for a in ARCH_IDS
                 for s in ("train_4k", "prefill_32k", "decode_32k",
                           "long_500k")
                 for m in ("single", "multi")]
        for arch, shape, meshk in cells:
            out_file = os.path.join(args.out, f"{arch}_{shape}_{meshk}.json")
            if os.path.exists(out_file):
                print(f"[skip] {arch} {shape} {meshk} (exists)", flush=True)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", meshk,
                   "--out", args.out]
            print(f"[cell] {arch} {shape} {meshk} ...", flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=3600)
            if r.returncode != 0:
                err = {"arch": arch, "shape": shape, "mesh": meshk,
                       "applicable": True, "error": r.stderr[-4000:]}
                with open(out_file, "w") as f:
                    json.dump(err, f, indent=1)
                print(f"  FAILED (see {out_file})", flush=True)
            else:
                print("  ok", flush=True)
        return

    overrides = json.loads(args.override) if args.override else None
    rec = run_cell(args.arch, args.shape, args.mesh, overrides)
    suffix = ""
    if args.override:
        suffix += "_ovr" + str(abs(hash(args.override)) % 10000)
    out_file = os.path.join(
        args.out, f"{args.arch}_{args.shape}_{args.mesh}{suffix}.json")
    with open(out_file, "w") as f:
        json.dump(rec, f, indent=1)
    print(roofline_line(rec))
    if "memory_analysis" in rec:
        print("memory_analysis:", rec["memory_analysis"])


if __name__ == "__main__":
    main()
