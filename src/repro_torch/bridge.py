"""Reference weights -> the port's modules.

Takes the JAX package's parameter pytree as numpy arrays (the output of
its ``init_lm`` / ``init_progen`` / ``init_foldscore`` after ``np.asarray``
on every leaf) and returns the port's ``LM`` / ``ProGen`` / ``FoldScore``
module holding the same values. Every leaf is a plain copy: the port
keeps the reference's layouts and keys (an ``rwkv`` layer's ``tm`` dict is
its ``ssm.Rwkv`` module; an ungated MLP has no ``wg`` on either side).
Each segment leaf stacked on a leading ``repeats`` axis is split into
per-layer tensors, in the order ``cfg.layer_kinds`` lists the layers
(``segments`` -> ``layers``), and likewise an encoder's
(``enc_segments`` -> ``enc_layers``, in ``cfg.encoder_kinds``' order).
``payload_namespaces_from_ref`` carries a reference ``ProteinPayload``'s
every param-set namespace into a port payload.

The inverse, ``ref_tree``, gives a port module's weights in the
reference's layout: the same nested keys, each segment's layer leaves
stacked on a leading ``repeats`` axis. Checkpoints are keyed by it (so
both packages' files hold the same arrays), ``ref_ndims`` gives each
parameter's rank there (which decides AdamW's weight decay) and
``module_from_ref`` rebuilds a module like a template from such a tree. A
reference -> port -> reference round trip is bitwise.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import whole
from repro_torch.learn.param_store import ParamStore
from repro_torch.models.lm import LM
from repro_torch.models.protein import FoldScore, ProGen


def _load(module, tree, prefix, take, filled):
    """Copy the leaves of ``tree`` (numpy arrays or tensors) into
    ``module``'s parameters of the same names."""
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        target = getattr(module, name)
        if isinstance(sub, dict):
            _load(target, sub, path + ".", take, filled)
            continue
        arr = take(sub)
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.array(arr, copy=True))
        if tuple(target.shape) != tuple(arr.shape):
            raise ValueError(f"{path}: reference shape {tuple(arr.shape)}, "
                             f"port shape {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(arr)
        filled.add(path)


# (reference key of the stacked segments, port layer list, config field)
_STACKS = (("segments", "layers", "segments"),
           ("enc_segments", "enc_layers", "encoder_segments"))


def _from_ref(module, params, cfg):
    params = dict(params)
    stacks = [(params.pop(key), name, getattr(cfg, field))
              for key, name, field in _STACKS if key in params]
    filled = set()
    _load(module, params, "", lambda a: a, filled)
    for segments, name, plan in stacks:
        layers = iter(enumerate(getattr(module, name)))
        for seg, (kinds, reps) in zip(segments, plan):
            for r in range(reps):
                for i, kind in enumerate(kinds):
                    idx, layer = next(layers)
                    _load(layer, seg[f"{i}_{kind}"], f"{name}.{idx}.",
                          lambda a, r=r: a[r], filled)
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



def _put(tree, path, leaf):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _host(tensors, stacked):
    """The default ``ref_tree`` leaf: a host numpy copy, stacked (a DTensor
    gathered whole first)."""
    tensors = [whole(t) for t in tensors]
    t = torch.stack(tensors) if stacked else tensors[0]
    return t.detach().cpu().numpy()


def ref_tree(module, leaf=_host):
    """``module``'s weights (an LM, ProGen or FoldScore, which carries its
    ``cfg``) in the reference's pytree layout: top-level leaves by their
    names, and ``segments`` (and an encoder's ``enc_segments``), a list
    with one dict a segment whose ``f"{i}_{kind}"`` entries stack that
    block position's layer leaves on a leading ``repeats`` axis. Each leaf
    is ``leaf(tensors, stacked)``, by default a host numpy array."""
    cfg = module.cfg
    tree = {}
    for name, p in module.named_parameters():
        if not _stacked(name):
            _put(tree, name.split("."), leaf([p], False))
    for key, name, field in _STACKS:
        plan = getattr(cfg, field)
        if not plan:
            continue
        layers, at, segments = list(getattr(module, name)), 0, []
        for kinds, reps in plan:
            seg = {}
            for i, kind in enumerate(kinds):
                group = [dict(layers[at + r * len(kinds) + i]
                              .named_parameters()) for r in range(reps)]
                sub = seg[f"{i}_{kind}"] = {}
                for pname in group[0]:
                    _put(sub, pname.split("."),
                         leaf([g[pname] for g in group], True))
            segments.append(seg)
            at += reps * len(kinds)
        tree[key] = segments
    return tree


def _stacked(name):
    """Whether a parameter is a layer's, stacked on ``repeats`` in the
    reference's layout."""
    return name.startswith(tuple(f"{n}." for _, n, _ in _STACKS))


def ref_ndims(module):
    """Each parameter's rank in the reference's layout: a layer's leaves
    carry the stacked ``repeats`` axis there, one more than here."""
    return {n: p.dim() + _stacked(n) for n, p in module.named_parameters()}


def module_from_ref(tree, template):
    """A module of ``template``'s class and config, on its device and in
    its parameters' dtypes (no gradients), holding the reference-layout
    ``tree``'s values."""
    out = _from_ref(type(template)(template.cfg), tree, template.cfg)
    p0 = next(template.parameters())
    return out.to(device=p0.device)


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
