"""Closed-loop training: back-to-back steps of the port's train step on
token batches drawn from the seed.

Mix parameters: ``rows``, ``seq`` (tokens a row), ``check_steps`` (the
steps of set-up that the reference follows), ``trace_steps`` (steps a
traced pass), ``opt`` (the optimizer, as ``repro_torch.optim.OptConfig``
takes it and the reference follows it).

Set-up builds the step with ``repro_torch.launch.train.build``, loads the
seed's weights into its module, and drives it through ``check_steps``
steps of the window's own feed, recording each loss, the first step's
global gradient norm and each leaf's gradient as AdamW took it (its first
moment over 1 - b1), and each leaf's change after the last of them. The
window then runs steps until ``seconds`` have passed, each ending when its
loss is on the host, as the port's launcher reads it. After the window the
program's state is freed and the reference follows the same steps from the
same weights; ``perfbench/lib/judge.py`` compares.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import torch

from perfbench.lib import judge, portcfg, trace, weights
from perfbench.lib import yardstick as ys


class Feed:
    """Token rows for step i: uniform ids in [0, vocab) from a generator
    on the device seeded from (seed, i); inputs and next-token targets."""

    def __init__(self, seed, rows, seq, vocab, device):
        self.seed, self.rows, self.seq, self.vocab = seed, rows, seq, vocab
        self.device = device

    def __call__(self, i):
        g = torch.Generator(device=self.device).manual_seed(
            weights.piece_seed(self.seed, 1_000_003 + i))
        ids = torch.randint(0, self.vocab, (self.rows, self.seq + 1),
                            generator=g, device=self.device)
        return ids[:, :-1], ids[:, 1:]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx):
    from repro_torch.launch import train as tr
    from repro_torch.optim import OptConfig

    mix, c, dev = ctx.mix, ctx.config, ctx.device
    rows, seq, n_check = mix["rows"], mix["seq"], mix["check_steps"]
    cfg = portcfg.build(c)
    opt = OptConfig(**mix["opt"])
    leaves = ctx.reference.leaves(c)
    params, opt_state, step_fn = tr.build(cfg, opt, device=dev)
    named = dict(params.named_parameters())
    weights.fill(named, leaves, ctx.seed, dev)
    feed = Feed(ctx.seed, rows, seq, c["vocab_size"], dev)

    def step(i):
        nonlocal params, opt_state
        inputs, targets = feed(i)
        params, opt_state, m = step_fn(
            params, opt_state, {"inputs": inputs, "targets": targets})
        return m

    prog = {"loss": []}
    for i in range(n_check):
        m = step(i)
        prog["loss"].append(m["loss"].detach().float())
        if i == 0:
            prog["gnorm"] = m["grad_norm"].detach().float()
            prog["grad"] = weights.leaf_norms(opt_state["m"],
                                              1.0 / (1.0 - opt.b1))
    prog["change"] = weights.change_norms(named, leaves, ctx.seed, dev)
    prog["loss"] = [float(x) for x in prog["loss"]]
    prog["gnorm"] = float(prog["gnorm"])
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    done = failed = 0
    times = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        loss = float(step(n_check + done)["loss"])
        times.append(time.perf_counter() - ts)
        done += 1
        failed += not math.isfinite(loss)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    tokens = done * rows * seq
    print(f"[train] {done} steps in {window_s:.3f} s; a step's seconds: "
          f"median {statistics.median(times):.6f}, least {min(times):.6f}, "
          f"most {max(times):.6f}", file=sys.stderr, flush=True)
    out = {
        "e2e": {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s},
        "attempted": done, "failed": failed,
        "record": {"window_s": window_s, "tokens": tokens,
                   "model_flops": done * ys.train_flops(
                       leaves, ctx.reference.mixers(c), rows, seq)},
    }
    if ctx.trace:
        at = [n_check + done]

        def steps():
            for _ in range(mix["trace_steps"]):
                float(step(at[0])["loss"])
                at[0] += 1
        out["trace"] = trace.device_pass(steps)
        out["trace"]["entries"], out["trace"]["gaps"] = trace.entry_pass(
            steps, ctx.entries)
    out["memory_peak_bytes"] = ctx.memory_peak()
    del params, opt_state, step_fn, named
    gc.collect()
    ctx.free()

    out["checks"], out["control"] = judge.train_follow(
        ctx, leaves, feed, n_check, prog)
    return out
