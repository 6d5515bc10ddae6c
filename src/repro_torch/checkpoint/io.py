"""Checkpoint I/O: one ``.npz`` of path-keyed arrays plus a manifest
(tree structure, shapes, dtypes, a crc32 a array, the step). A port of the
JAX package's ``repro.checkpoint.io``.

Trees are nested dicts / lists / tuples of tensors, numpy arrays or
scalars, or a model module (``LM``, ``ProGen``, ``FoldScore``), which is
stored in the reference's layout (``bridge.ref_tree``: layer leaves stacked
per segment). Keys are the reference's ``_flatten`` keys (path parts
joined by "/", e.g. ``segments/0/0_attn/attn/wq``), so for the same
weights both packages' ``.npz`` files hold the same arrays under the same
keys, with the same crc32s. bf16 arrays are stored as 2-byte void arrays,
as numpy stores the reference's ``ml_dtypes`` bf16.

The manifest differs in format only: the reference writes msgpack to
``<path>.manifest``; the port, which has no msgpack, writes the same fields
as JSON to ``<path>.manifest.json``. A reference checkpoint loaded here has
no such manifest and loads unchecked, as the reference loads a legacy
checkpoint.

Durability: the ``.npz`` and the manifest are each written atomically
(tempfile + ``os.replace``), and ``load_pytree`` verifies every array it
reads against the manifest's crc32, raising
:class:`CheckpointCorruptError` on a mismatch or on bytes that do not
decode, so the ``CheckpointManager`` can fall back to an older copy.
``verify_checkpoint`` runs the same check without building the tree. An
optional ``fault_plan`` (anything with ``on_checkpoint_saved(path)``)
sees the just-written file: the chaos path for this machinery. The
reference's per-host ``shard_suffix`` is not ported: the port writes one
file per checkpoint. A DTensor leaf (a mesh run's parameters and moments)
is gathered whole before it is written, and ``load_pytree``'s
``placements`` distributes each loaded leaf again, as the reference's
restore ``device_put``s to its ``shardings``; so a checkpoint restores into
any mesh, or none.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import distribute_params, whole

MANIFEST = ".manifest.json"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its checksum (or could not be decoded)."""


def _items(tree, path=()):
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, sequences by index, a module as its ``bridge.ref_tree``."""
    if isinstance(tree, nn.Module):
        from repro_torch.bridge import ref_tree
        tree = ref_tree(tree)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    else:
        yield path, tree


def _treedef(tree) -> str:
    """The tree's structure, written as the reference's manifest writes
    its ``PyTreeDef``."""
    def rec(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {rec(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(rec(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(rec(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    if isinstance(tree, nn.Module):
        from repro_torch.bridge import ref_tree
        tree = ref_tree(tree, leaf=lambda ts, stacked: None)
    return f"PyTreeDef({rec(tree)})"


def _host(leaf):
    """(numpy array, dtype name) of a leaf; bf16 as 2-byte voids."""
    if isinstance(leaf, torch.Tensor):
        t = whole(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _atomic_write(path, write):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    with os.fdopen(fd, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_pytree(tree, path, *, step=None, fault_plan=None):
    """Atomically write ``tree`` to ``path`` (``.npz`` + ``.manifest.json``).
    Returns the ``.npz``'s path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for p, leaf in _items(tree):
        key = "/".join(p)
        arrays[key], dtypes[key] = _host(leaf)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": dtypes,
        "checksums": {k: _crc(v) for k, v in arrays.items()},
        "treedef": json.dumps(_treedef(tree)),
    }
    npz_path = path + ".npz"
    _atomic_write(npz_path, lambda f: np.savez(f, **arrays))
    _atomic_write(path + MANIFEST,
                  lambda f: f.write(json.dumps(manifest).encode()))
    if fault_plan is not None:
        fault_plan.on_checkpoint_saved(npz_path)
    return npz_path


def _load_manifest(path):
    try:
        with open(path + MANIFEST, "rb") as f:
            return json.loads(f.read())
    except FileNotFoundError:
        return None
    except Exception as e:  # truncated/garbled JSON
        raise CheckpointCorruptError(
            f"manifest unreadable: {path}{MANIFEST} ({e!r})") from e


def _read_arrays(path, checksums):
    """Every array of the ``.npz``, each checked against ``checksums``."""
    try:
        with np.load(path + ".npz") as data:
            arrays = {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except Exception as e:  # zip/npy decode failure = corrupted bytes
        raise CheckpointCorruptError(
            f"checkpoint unreadable: {path}.npz ({e!r})") from e
    for k, arr in arrays.items():
        want = checksums.get(k)
        if want is not None and _crc(arr) != want:
            raise CheckpointCorruptError(
                f"checksum mismatch for array {k!r} in {path}.npz")
    return arrays


def _as_tensor(arr, dtype, device):
    """A stored array as a tensor of ``dtype`` on ``device``."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True)).to(dtype)
    return t.to(device)


def _sub(placements, key):
    return None if placements is None else placements.get(key)


def _rebuild(template, arrays, path, where, placements=None):
    """``template``'s structure holding the stored arrays: tensors like the
    template's tensors (dtype, device), numpy arrays elsewhere; a tensor
    whose ``placements`` entry is (mesh, placements) distributed so, a
    module's parameters by the entry's {name: (mesh, placements)}."""
    if isinstance(template, nn.Module):
        from repro_torch.bridge import module_from_ref, ref_tree
        spec = ref_tree(template, leaf=lambda ts, stacked: ts[0])
        tree = _rebuild(spec, arrays, path, where)
        out = module_from_ref(tree, template)
        if placements:
            distribute_params(out, placements)
        return out
    if isinstance(template, dict):
        return {k: _rebuild(v, arrays, path + (str(k),), where,
                            _sub(placements, k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, arrays, path + (str(i),), where,
                                       _sub(placements, i))
                              for i, v in enumerate(template))
    key = "/".join(path)
    try:
        arr = arrays[key]
    except KeyError as e:
        raise CheckpointCorruptError(
            f"array {key!r} missing from {where}") from e
    if isinstance(template, torch.Tensor):
        t = _as_tensor(arr, template.dtype, template.device)
        if placements is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        mesh, pl = placements
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    want = np.asarray(template).dtype
    if arr.dtype != want:
        arr = arr.view(want) if arr.dtype.kind == "V" \
            and arr.dtype.itemsize == want.itemsize else arr.astype(want)
    return arr


def _checksums(path):
    manifest = _load_manifest(path)
    return (manifest.get("checksums") or {}) if manifest else {}


def load_pytree(template, path, placements=None):
    """Load into the structure of ``template``: a module comes back as a
    new module of its class (``bridge.module_from_ref``), a tensor as a
    tensor of the template's dtype on its device, anything else as a numpy
    array of its dtype. ``placements`` mirrors ``template`` where leaves
    are to be DTensors: (mesh, placements) for a tensor, {parameter name:
    (mesh, placements)} for a module. Every array read is checked against
    the manifest's crc32; a checkpoint without a manifest loads
    unchecked."""
    arrays = _read_arrays(path, _checksums(path))
    return _rebuild(template, arrays, (), f"{path}.npz", placements)


def verify_checkpoint(path) -> bool:
    """True when every array in ``path``'s ``.npz`` matches its manifest
    checksum (a checkpoint without checksums passes if its ``.npz``
    decodes); False on any corruption."""
    try:
        _read_arrays(path, _checksums(path))
        return True
    except FileNotFoundError:
        raise
    except Exception:
        return False


def manifest_step(path):
    with open(path + MANIFEST) as f:
        return json.load(f).get("step")
