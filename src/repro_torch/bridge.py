"""Reference weights -> the port's modules.

Takes the JAX package's parameter pytree as numpy arrays (the output of
its ``init_lm`` / ``init_progen`` / ``init_foldscore`` after ``np.asarray``
on every leaf) and returns the port's ``LM`` / ``ProGen`` / ``FoldScore``
module holding the same values. Every leaf is a plain copy: the port
keeps the reference's layouts and keys (an ``rwkv`` layer's ``tm`` dict is
its ``ssm.Rwkv`` module). Each segment leaf stacked on a leading ``repeats`` axis is split
into per-layer tensors, in the order ``cfg.layer_kinds`` lists the layers.
``payload_namespaces_from_ref`` carries a reference ``ProteinPayload``'s
every param-set namespace into a port payload.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.learn.param_store import ParamStore
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



def _port_cfg(cfg):
    """The port's ``ModelConfig`` holding a reference config's fields."""
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


def payload_namespaces_from_ref(ref, port) -> None:
    """Carry every param-set namespace of the reference's ``ProteinPayload``
    ``ref`` into the port's payload ``port`` (one that has not run yet):
    each generator store's current (version, weights) and each scorer
    set's weights, with their configs, through numpy. The port's store of a
    namespace takes the reference's version number; a namespace the port
    payload already holds is replaced."""
    for ns, store in ref.gen_stores.items():
        ver, params = store.current()
        cfg = _port_cfg(ref.gen_cfgs[ns])
        module = progen_from_ref(_to_numpy(params), cfg).to(port.device)
        port_store = ParamStore(module, version=ver)
        port_store.on_retire(partial(port._drop_gen_versions, ns))
        port.gen_stores[ns], port.gen_cfgs[ns] = port_store, cfg
    port.param_store = port.gen_stores["default"]
    port.gen_cfg = port.gen_cfgs["default"]
    for ns, (cfg, params) in ref.fold_sets.items():
        cfg = _port_cfg(cfg)
        port.fold_sets[ns] = (cfg, foldscore_from_ref(
            _to_numpy(params), cfg).to(port.device))
    port.fold_cfg, port.fold_params = port.fold_sets["default"]
