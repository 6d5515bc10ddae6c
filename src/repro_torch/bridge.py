"""Reference weights -> the port's modules.

Takes the JAX package's parameter pytree as numpy arrays (the output of
its ``init_lm`` / ``init_progen`` / ``init_foldscore`` after ``np.asarray``
on every leaf) and returns the port's ``LM`` / ``ProGen`` / ``FoldScore``
module holding the same values. Every leaf is a plain copy: the port
keeps the reference's layouts and keys (an ``rwkv`` layer's ``tm`` dict is
its ``ssm.Rwkv`` module). Each segment leaf stacked on a leading ``repeats`` axis is split
into per-layer tensors, in the order ``cfg.layer_kinds`` lists the layers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.models.protein import FoldScore, ProGen


def _load(module, tree, prefix, take, filled):
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        target = getattr(module, name)
        if isinstance(sub, dict):
            _load(target, sub, path + ".", take, filled)
            continue
        arr = np.asarray(take(sub))
        if tuple(target.shape) != arr.shape:
            raise ValueError(f"{path}: reference shape {arr.shape}, port "
                             f"shape {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(arr, copy=True)))
        filled.add(path)


def _from_ref(module, params, cfg):
    params = dict(params)
    segments = params.pop("segments")
    filled = set()
    _load(module, params, "", lambda a: a, filled)
    layers = iter(enumerate(module.layers))
    for seg, (kinds, reps) in zip(segments, cfg.segments):
        for r in range(reps):
            for i, kind in enumerate(kinds):
                idx, layer = next(layers)
                _load(layer, seg[f"{i}_{kind}"], f"layers.{idx}.",
                      lambda a, r=r: np.asarray(a)[r], filled)
    missing = {n for n, _ in module.named_parameters()} - filled
    if missing:
        raise ValueError(f"reference params leave {sorted(missing)} unset")
    return module


def lm_from_ref(params, cfg) -> LM:
    """The reference's ``init_lm`` params (numpy leaves) as an LM."""
    return _from_ref(LM(cfg), params, cfg)


def progen_from_ref(params, cfg) -> ProGen:
    """The reference's ``init_progen`` params (numpy leaves) as a ProGen."""
    return _from_ref(ProGen(cfg), params, cfg)


def foldscore_from_ref(params, cfg) -> FoldScore:
    """The reference's ``init_foldscore`` params (numpy leaves) as a
    FoldScore."""
    return _from_ref(FoldScore(cfg), params, cfg)
