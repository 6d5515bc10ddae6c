"""Faults planted in the timed path, to show that the check catches them: the
CPU tests run a cell with each one its loop can have and see ``correct``
come out false, and ``perfbench/control.py --fault`` reads them on the chip
at the cell's size. Never used by a benchmark run.

Each is a context manager that replaces a function of the program in this
process and puts it back:

  training  frozen_step   the step computes its loss and gradients and
                          returns its state unchanged
            half_batch    the step sees half of the rows: the loss is the
                          mean over the rest
  serving   frozen_state  a decode step returns the caches it was given
            half_batch    the prefill runs the first half of the rows and
                          hands the second half the first half's results
            altered_token a decode step's logits moved one place along the
                          vocabulary, so another token is served
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _replaced(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _train_step(wrap):
    from repro_torch.launch import train as tr

    def make(orig):
        def make_train_step(cfg, opt, *a, **k):
            return wrap(orig(cfg, opt, *a, **k), cfg)
        return make_train_step
    return _replaced(tr, "make_train_step", make)


def frozen_step():
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import global_norm

    def wrap(step, cfg):
        def frozen(params, opt_state, batch):
            loss, metrics = lm.lm_loss(params, batch, cfg)
            named = [p for p in params.parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, named, allow_unused=True)
            gnorm = global_norm({i: g for i, g in enumerate(grads)
                                 if g is not None})
            return params, opt_state, dict(
                {k: v.detach() for k, v in metrics.items()},
                grad_norm=gnorm, lr=0.0)
        return frozen
    return _train_step(wrap)


def _half(batch):
    n = next(iter(batch.values())).shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def half_batch_train():
    def wrap(step, cfg):
        return lambda params, opt_state, batch: step(params, opt_state,
                                                     _half(batch))
    return _train_step(wrap)


def frozen_state():
    from repro_torch.models import lm

    def make(orig):
        def decode_step(params, caches, token, t, cfg):
            logits, _ = orig(params, caches, token, t, cfg)
            return logits, caches
        return decode_step
    return _replaced(lm, "decode_step", make)


def _tile(x, B):
    if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == B // 2:
        return torch.cat([x, x])
    if isinstance(x, dict):
        return {k: _tile(v, B) for k, v in x.items()}
    if isinstance(x, list):
        return [_tile(v, B) for v in x]
    return x


def half_batch_serve():
    from repro_torch.models import lm

    def make(orig):
        def prefill(params, batch, cfg, cache_len=0):
            B = batch["inputs"].shape[0]
            logits, caches, t = orig(params, _half(batch), cfg, cache_len)
            return _tile(logits, B), _tile(caches, B), t
        return prefill
    return _replaced(lm, "prefill", make)


def altered_token():
    from repro_torch.models import lm

    def make(orig):
        def decode_step(params, caches, token, t, cfg):
            logits, caches = orig(params, caches, token, t, cfg)
            return logits.roll(1, dims=-1), caches
        return decode_step
    return _replaced(lm, "decode_step", make)


FAULTS = {"train": {"frozen_step": frozen_step,
                    "half_batch": half_batch_train},
          "serve": {"frozen_state": frozen_state,
                    "half_batch": half_batch_serve,
                    "altered_token": altered_token}}
