"""Learning-rate schedules, plain functions of the step count (a port of
the JAX package's ``repro.optim.schedules``): linear warmup, then cosine,
linear or constant decay to ``min_lr_frac`` of the base rate. Computed in
fp32, as the reference computes them."""

from __future__ import annotations

import numpy as np


def make_schedule(opt):
    f32 = np.float32
    base, warm, total = f32(opt.lr), opt.warmup_steps, opt.total_steps
    floor = f32(opt.min_lr_frac) * base

    def fn(step) -> float:
        step = f32(step)
        if step < warm:
            return float(base * (step + f32(1)) / f32(max(warm, 1)))
        frac = np.clip((step - f32(warm)) / f32(max(total - warm, 1)),
                       f32(0), f32(1))
        if opt.schedule == "cosine":
            decayed = floor + f32(0.5) * (base - floor) * (
                f32(1) + np.cos(f32(np.pi) * frac))
        elif opt.schedule == "linear":
            decayed = base + (floor - base) * frac
        else:
            decayed = base
        return float(decayed)

    return fn
