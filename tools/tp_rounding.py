#!/usr/bin/env python3
"""How far rounding alone moves a model's training, without any mesh.

  PYTHONPATH=src python3 tools/tp_rounding.py [--arch A ...] [--steps N]
  PYTHONPATH=src python3 tools/tp_rounding.py --device cuda --layers 2 \\
      --batch 4 --seq 512 --parts 4 --steps 0 --arch llama3-8b
  PYTHONPATH=src python3 tools/tp_rounding.py --device cuda --layers 2 \\
      --batch 4 --seq 512 --parts 4 --steps 0 --serve --arch rwkv6-7b

Tensor parallelism over ``model`` splits a row-parallel product's sum into
one partial product a rank, added by an all-reduce; the result is the
unsharded product rounded otherwise. This tool measures what that costs
the comparisons of ``tests/test_torch_mesh_train.py``,
``tests/test_torch_tp.py`` and ``chip_smoke.py``'s phase 12 with no process
group: it runs the unsharded model as ``launch/train.py`` builds it, then
again with every feed-forward down-projection (the MLP's ``wo``, the rwkv
channel mix's ``wcv``: the products whose weight is d_ff x d_model) split
as ``--parts`` ranks split it (the rows in ``--parts`` blocks, the blocks'
products added), with ``--attn`` each attention output projection too
(its heads in ``--parts`` blocks: the only row-parallel product of an
all-MoE model such as qwen3-moe-30b-a3b), and prints:

- the first step's ``lm_loss`` gradients in each of ``--dtypes``: the
  worst leaf's max difference over that leaf's max, split against
  unsplit, and the unsplit step run twice (what the device's own
  nondeterminism moves, such as the card's atomic adds);
- with ``--steps`` > 0, the fp32 losses of that many AdamW steps (the
  tests' optimizer) and the worst leaf's max weight difference over that
  leaf's max;
- with ``--serve``, in place of the gradients: serving as phase 12 serves
  (the seeded prompts of ``--batch`` x ``--seq`` tokens, one prefill and
  ``--decode`` decode steps, each fed the unsplit run's greedy token), the
  prefill's and every step's logits, split against unsplit, the worst max
  difference over that call's max |logit|, and the unsplit run again.

The model is the arch's reduced config, or with ``--layers`` its full
config with the first segment cut to that many layers and the other
segments dropped (``chip_smoke.py``'s ``mesh_cfg``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


ATTN_OUT = "bshk,hkd->bsd"      # attention's output projection


def split_mode(cfg, parts, attn=False):
    """A ``TorchFunctionMode`` that computes each ``x @ w`` with w of shape
    (d_ff, d_model) as ``parts`` row blocks' products added, and with
    ``attn`` each attention output projection (``ATTN_OUT``) as ``parts``
    blocks of heads' products added; ``.calls`` counts the products it
    split."""
    import torch
    from torch.overrides import TorchFunctionMode

    shape = (cfg.d_ff, cfg.d_model)

    class Split(TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (getattr(func, "__name__", "") in ("matmul", "__matmul__")
                    and len(args) == 2 and not kwargs
                    and tuple(args[1].shape) == shape):
                x, w = args
                f = shape[0] // parts
                Split.calls += 1
                return sum(x[..., i * f:(i + 1) * f] @ w[i * f:(i + 1) * f]
                           for i in range(parts))
            if (attn and func is torch.einsum and len(args) == 3
                    and args[0] == ATTN_OUT and not kwargs):
                _, x, w = args
                h = w.shape[0] // parts
                Split.calls += 1
                return sum(torch.einsum(ATTN_OUT, x[:, :, i * h:(i + 1) * h],
                                        w[i * h:(i + 1) * h])
                           for i in range(parts))
            return func(*args, **kwargs)
    return Split()


def config(arch, dtype, layers):
    """The model, with remat off: a function mode does not follow autograd
    onto the card's backward thread, where remat's recompute runs (the
    recompute repeats the forward's ops, so the gradients are remat's)."""
    from repro_torch.configs.registry import get_config, get_reduced
    full = get_config(arch)
    if layers is None:
        return get_reduced(arch).replace(
            compute_dtype=dtype, fsdp=full.fsdp,
            moe_parallelism=full.moe_parallelism, remat="none")
    (kinds, _), *_ = full.segments
    reps = layers // len(kinds)
    return full.replace(segments=((kinds, reps),), n_layers=reps * len(kinds),
                        compute_dtype=dtype, remat="none")


def rel(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)


def worst(got, want):
    name = max(want, key=lambda n: rel(got[n], want[n]))
    return name, rel(got[name], want[name])


def train(cfg, args, mode):
    from repro_torch.launch import train as tr
    from repro_torch.optim import OptConfig
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    with mode:
        params, _, losses = tr.train(cfg, opt, steps=args.steps,
                                     batch=args.batch, seq=args.seq,
                                     log_every=100, device=args.device)
    return losses, {n: p.detach() for n, p in params.named_parameters()}


def first_grads(cfg, args, mode):
    import torch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import lm
    from repro_torch.models.common import trainable
    params = trainable(lm.init_lm(cfg, seed=0, device=args.device))
    named = list(params.named_parameters())
    batch = {k: v.to(args.device) for k, v in
             lm_batch(cfg, args.batch, args.seq, seed=0, step=0).items()}
    with mode:
        loss = lm.lm_loss(params, batch, cfg)[0]
        grads = torch.autograd.grad(loss, [p for _, p in named])
    return {n: g.detach() for (n, _), g in zip(named, grads)}


def serve_logits(cfg, args, mode, tokens=None):
    """The prefill's and each decode step's fp32 logits from seed 0's
    weights over phase 12's seeded prompts, each step fed ``tokens[s]``
    (None: the run's own greedy tokens). Returns (logits, tokens)."""
    import torch
    from repro_torch.models import lm
    gen = torch.Generator(device=args.device).manual_seed(44)
    inputs = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                           generator=gen, device=args.device)
    params = lm.init_lm(cfg, seed=0, device=args.device)
    out, own = [], []
    with torch.no_grad(), mode:
        logits, caches, t = lm.prefill(params, {"inputs": inputs}, cfg,
                                       args.seq + args.decode)
        for s in range(args.decode + 1):
            out.append(logits.float())
            own.append(logits.argmax(-1)[:, None])
            if s == args.decode:
                break
            feed = own[s] if tokens is None else tokens[s]
            logits, caches = lm.decode_step(params, caches, feed, t + s, cfg)
    return out, own


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+",
                    default=["rwkv6-7b", "recurrentgemma-2b", "llama3-8b"])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--parts", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--decode", type=int, default=8)
    ap.add_argument("--attn", action="store_true",
                    help="also split attention's output projections")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import contextlib
    for arch in args.arch:
        if args.steps:
            cfg = config(arch, "float32", args.layers)
            base_losses, base = train(cfg, args, contextlib.nullcontext())
            mode = split_mode(cfg, args.parts, args.attn)
            losses, weights = train(cfg, args, mode)
            assert mode.calls, f"{arch}: no product split"
            name, err = worst(weights, base)
            print(f"{arch}: fp32 losses {base_losses} unsplit, {losses} "
                  f"split; weights after {args.steps} AdamW steps: worst "
                  f"leaf {name} {err:.3e} of its max", flush=True)
        for dtype in args.dtypes:
            cfg = config(arch, dtype, args.layers)
            if args.serve:
                base, toks = serve_logits(cfg, args, contextlib.nullcontext())
                mode = split_mode(cfg, args.parts, args.attn)
                got, _ = serve_logits(cfg, args, mode, toks)
                assert mode.calls, f"{arch}: no product split"
                again, _ = serve_logits(cfg, args, contextlib.nullcontext(),
                                        toks)
                moves = [rel(g, b) for g, b in zip(got, base)]
                print(f"{arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
                      f"{args.batch} x {args.seq}, {mode.calls} products "
                      f"split in {args.parts}): {dtype} prefill + "
                      f"{args.decode} decode steps' logits: worst "
                      f"{max(moves):.3e} of a call's max |logit| "
                      f"({['%.2e' % m for m in moves]}); the unsplit run "
                      f"again: worst "
                      f"{max(rel(a, b) for a, b in zip(again, base)):.3e}",
                      flush=True)
                continue
            base = first_grads(cfg, args, contextlib.nullcontext())
            mode = split_mode(cfg, args.parts, args.attn)
            got = first_grads(cfg, args, mode)
            assert mode.calls, f"{arch}: no product split"
            again = worst(first_grads(cfg, args, contextlib.nullcontext()),
                          base)
            name, err = worst(got, base)
            top = max(float(g.abs().max()) for g in base.values())
            print(f"{arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
                  f"{args.batch} x {args.seq}, {mode.calls} products split "
                  f"in {args.parts}): {dtype} first step's gradients: worst "
                  f"leaf {name} {err:.3e} of its max (that max "
                  f"{float(base[name].abs().max()):.3e}, the largest leaf's "
                  f"{top:.3e}); the unsplit step run again: worst leaf "
                  f"{again[0]} {again[1]:.3e}", flush=True)
            del base, got


if __name__ == "__main__":
    main()
