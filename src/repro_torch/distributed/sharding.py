"""Sharding rule engine: FSDP / TP / SP / EP, divisibility-aware (a port of
the JAX package's ``repro.distributed.sharding``).

Parameters are assigned specs by *path + shape* rules (t5x-style logical
axes, resolved against the mesh). A tensor axis is sharded on a mesh axis
only when the dimension divides evenly; otherwise the rule falls through to
replication — this is how whisper's 12 heads or smollm's 15 heads stay
replicated on ``model`` while their FFNs carry the tensor parallelism.

A spec is the port's own value, not JAX's ``PartitionSpec``: a tuple with,
for each tensor dim, a tuple of mesh-axis names or None (the reference's
``P()`` is ``()``; a dim past the spec's end is replicated). ``placements``
turns it into DTensor placements on a torch ``DeviceMesh``. The rules work
on any mesh object with axis names and a device-array shape: a
``DeviceMesh`` (``mesh_dim_names``, ``shape``) or the reference's test
stubs (``axis_names``, ``devices.shape``), so they run without a process
group.

The port's parameters live per layer (``bridge``); the rules are the
reference's, keyed by the reference's paths and stacked shapes
(``param_paths``): a stacked leaf ``(repeats, ...)`` has a None repeats
axis, so the port's per-layer leaf takes the same spec without it. Caches
likewise (``cache_spec_tree``).

Storage (``shard_module``): each trainable parameter is a DTensor with its
spec's placements, as the reference stores it. Activations are plain local
tensors; a kernel never sees a DTensor.

Compute (``gather``, ``tp``). In a train step on a mesh
(``activation_sharding(mesh, cfg, "train")``, which ``optim.train_step``
enters; a prefill on a mesh too, forward only, as the reference compiles
its prefill from the train rules) the step is tensor-parallel over
``model``, as GSPMD computes the reference's jitted step from the same
rules. ``gather`` collects a parameter over the dp axes only (the
reference's FSDP storage on ``data``, gathered at use) and hands the layer
its local ``model`` shard: each rank computes the column-parallel products
on its heads, ff, lru or vocab slice and the row-parallel products
(``attn/wo``, ``mlp/wo``, ``tm/wo``, ``tm/wcv``, ``rec/wout``) on its rows
of the weight, as Megatron-LM splits them. ``copy_to_model`` goes before
each column-parallel product (identity forward, all-reduce of the gradient
over ``model``) and ``reduce_from_model`` after each row-parallel one
(all-reduce forward, identity backward), so the residual stream and every
replicated parameter's gradient are the same on every ``model`` rank. A
replicated parameter that each rank slices to its own heads or channels
(rwkv's ``u``, the group norm, the rglru gates' biases, a KV projection
that the rules replicate) is gathered with ``use="partial"``: its gradient
is summed over ``model``.

Expert parallelism (``moe_split``): the MoE's capacity form splits where
the reference's constraints split it. With ``moe_parallelism="ep"``
(llama4) each ``model`` rank takes its shard of the experts along E
(``use="local"``; the train rules store them over ``"experts"``), so no
expert weight moves over ``model`` and each rank's gradient stays on its
shard; the partial outputs are summed over ``model``. With ``"fsdp"``
(qwen3) the groups split over dp and ``model`` where they divide both
(``"expert_group_all"``), the experts gathered whole over ``data``
(``use="partial"``: each rank's gradient is its groups' share), and an
all-to-all over ``model`` (``all_to_all_model``) hands each rank the rows of
its groups under sequence parallelism.

Sequence parallelism (``seq_split``): where the config sets
``sequence_parallel`` (the reference's logical ``"seq"`` resolves to
``model``) and the sequence divides ``model``, a train step's residual
stream is the rank's ``(B, S / model, d)`` chunk from the embedding to the
final norm, as the reference constrains it to ``("batch", "seq", None)``:
the norms and residual adds run on the chunk (their replicated scales
gathered with ``use="partial"``), ``gather_seq`` stands where
``copy_to_model`` stood before each column-parallel block and
``scatter_seq`` where ``reduce_from_model`` stood after it, as Megatron-LM
splits the sequence. Context parallelism (``context_parallel``): where the
query heads do not divide ``model`` (``use_context_parallel``: whisper's
12, smollm's 15, recurrentgemma's 10 or llava's 56 heads on 16 ranks) the
rules replicate attention's weights, and each rank computes attention for
its chunk of the query sequence over the keys of every position, flash
taking the chunk's offset (``models.attention``), as the reference shards
the query sequence (its ``_cp``). ``constrain`` has nothing to impose on a
local tensor and returns its input: the layers call these operators
themselves.

A decode step on a mesh (``activation_sharding(mesh, cfg, "serve")``, the
parameters stored by the serve rules) computes along ``model`` as a train
step does, and along ``data`` on the serve rules' second tensor axis: the
would-be-FSDP dim of each weight (``"data2d"``) stays on its ``data`` rank
and the activations move (``dot``: the token rows gathered over ``data``,
multiplied by the rank's slice, the partial products or the output columns
summed over ``data``); ``gather`` then gathers no parameter (a
``"whole"`` use would), and the MoE experts stay where the serve rules
store them: on ``model`` along E, llama4's also on ``data`` along ``f``
(``moe_split``; the dispatch rows move over ``data`` and ``wo``'s
products are summed over it, ``sum_over_data``). The caches are the
rank's shards as
``cache_spec_tree`` places them (``local_cache``): batch rows over the dp
axes, KV heads over ``model`` (the head dim where they do not divide),
rwkv's ``S`` over heads, rglru's ``h`` and ``conv`` over lru channels. A
step outside any context, on any thread but the one that entered it
(the contexts are per thread; ``running`` and ``resume`` carry them onto
autograd's backward thread), computes unsharded, every parameter gathered
whole.

The collectives of the compute are ``torch.distributed``'s functional ones
(``_functional_collectives``), which ``distributed/cost.py`` counts by kind
and the dry run's fake group accepts; they are all-reduces, and each
all-gather of an activation (``gather_from_model``: the rglru gates' input,
a head-dim-split cache, a context-parallel chunk's output; ``gather_seq``;
``rows_over_data``, ``columns_over_data``) is an all-reduce of the rank's
slice in a zeroed buffer, each reduce-scatter (``scatter_seq``,
``gather_seq``'s backward) an all-reduce of which the rank keeps its
chunk, so the same code runs on NCCL and on gloo with CUDA tensors (four
processes sharing one card), whose all-gather of CUDA tensors does not
complete under torch 2.11. Both stand-ins are exact. The MoE's all-to-all
is ``all_to_all_single`` itself, which gloo completes for CUDA tensors
(``tools/gloo_cuda_probe.py``).
"""

from __future__ import annotations

import contextlib
import re
import sys
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# meshes and activation constraints
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


def _stack() -> list:
    """This thread's stack of (mesh, cfg, mode, split_rows): a step on one
    thread leaves every other thread's layers as they are."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


@contextlib.contextmanager
def activation_sharding(mesh, cfg, mode: str = "train",
                        split_rows: bool = True):
    """Install mesh + config on this thread so ``constrain``,
    ``use_context_parallel`` and ``tp`` see them. ``split_rows``: whether
    each dp rank holds its own batch rows (``tokens_sharding``) or all of
    them; a serve step's ``"data2d"`` products gather the rows over
    ``data`` only in the first case."""
    stack = _stack()
    stack.append((mesh, cfg, mode, split_rows))
    try:
        yield
    finally:
        stack.pop()


def running() -> tuple:
    """This thread's ``activation_sharding`` contexts, for ``resume``."""
    return tuple(_stack())


@contextlib.contextmanager
def resume(state):
    """Run the block in the contexts ``running()`` gave on another thread
    (autograd's backward thread, where remat recomputes a forward), this
    thread's own set aside meanwhile."""
    saved = getattr(_LOCAL, "stack", None)
    _LOCAL.stack = list(state)
    try:
        yield
    finally:
        _LOCAL.stack = saved


def active_mode() -> str:
    stack = _stack()
    return stack[-1][2] if stack else "train"


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def _axes(mesh) -> dict:
    shape = (mesh.devices.shape if hasattr(mesh, "devices")
             else tuple(mesh.shape))
    return dict(zip(axis_names(mesh), shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _fit(dim: int, axes, mesh) -> Optional[Tuple[str, ...]]:
    """Return the mesh axes if ``dim`` divides their product, else None."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    size = int(np.prod([_axes(mesh)[a] for a in axes]))
    return tuple(axes) if dim % size == 0 and dim >= size else None


def resolve_logical(logical, shape, mesh, cfg):
    """Map a tuple of logical names to a spec for ``shape``."""
    spec = []
    for dim, name in zip(shape, logical):
        if name is None:
            spec.append(None)
            continue
        axes = {
            "batch": dp_axes(mesh),
            "expert_group": dp_axes(mesh),
            "expert_group_all": dp_axes(mesh) + ("model",),
            "data2d": ("data",),
            "seq": (("model",) if getattr(cfg, "sequence_parallel", False)
                    else None),
            "vocab": ("model",),
            "heads": ("model",),
            "kv_heads": ("model",),
            "experts": ("model",),
            "ff": ("model",),
            "lru": ("model",),
            "fsdp": ("data",) if getattr(cfg, "fsdp", False) else None,
            "model": ("model",),
        }[name]
        fit = _fit(dim, axes, mesh)
        if fit is None and name == "expert_group_all":
            fit = _fit(dim, dp_axes(mesh), mesh)  # fall back to dp-only
        spec.append(fit)
    return tuple(spec)


def constrain(x, logical):
    """The reference's activation constraint. Compute here is data-parallel
    on local tensors, so there is no layout to impose: ``x`` as it is."""
    return x


def use_context_parallel(n_heads: int) -> bool:
    """Whether the reference shards attention's query sequence over
    ``model`` (the head axis does not divide it: whisper 12, smollm 15, RG
    10, llava 56 vs 16-way TP): the rule, on the mesh in force (a test stub
    too); ``context_parallel`` adds the step's and the sequence's fit."""
    stack = _stack()
    if not stack:
        return False
    m = _axes(stack[-1][0]).get("model", 1)
    return n_heads % m != 0 and m > 1


def _fits_model(S: int, t) -> bool:
    return t.size > 1 and _fit(S, ("model",), t.mesh) is not None


def context_parallel(n_heads: int, S: int) -> bool:
    """Whether attention with ``n_heads`` query heads over ``S`` queries
    computes this rank's chunk of the query sequence: a tensor-parallel
    step (``tp``), ``use_context_parallel``, and ``S`` split over
    ``model`` as the reference's ``_fit`` splits a dim (it divides
    ``model`` and is at least as long); elsewhere attention computes
    whole, as the reference's constraint then leaves the axis
    replicated."""
    t = tp()
    return _fits_model(S, t) and use_context_parallel(n_heads)


def seq_split(S: int, cfg) -> bool:
    """Whether this step's residual stream of ``S`` positions is split over
    ``model`` (sequence parallelism): a train-mode tensor-parallel step,
    ``cfg.sequence_parallel`` (the reference's ``"seq"`` axis then
    resolves to ``model``) and ``S`` split by ``_fit``."""
    t = tp()
    return (t.mode == "train" and getattr(cfg, "sequence_parallel", False)
            and _fits_model(S, t))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

# (path regex, logical axes per dim). First match wins. "F" = fsdp.
_PARAM_RULES = [
    (r"embedding/tok$", ("vocab", "fsdp")),
    (r"lm_head/w$", ("fsdp", "vocab")),
    (r"(attn|xattn)/wq$", ("fsdp", "heads", None)),
    (r"(attn|xattn)/w[kv]$", ("fsdp", "kv_heads", None)),
    (r"(attn|xattn)/wo$", ("heads", None, "fsdp")),
    (r"mlp/w[ig]$", ("fsdp", "ff")),
    (r"mlp/wo$", ("ff", "fsdp")),
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w[ig]$", ("experts", "fsdp", None)),
    (r"moe/wo$", ("experts", None, "fsdp")),
    (r"moe/shared/w[ig]$", ("fsdp", "ff")),
    (r"moe/shared/wo$", ("ff", "fsdp")),
    (r"tm/w[rkvg]$", ("fsdp", "heads_flat")),
    (r"tm/wo$", ("heads_flat", "fsdp")),
    (r"tm/wc[k]$", ("fsdp", "ff")),
    (r"tm/wcv$", ("ff", "fsdp")),
    (r"tm/wcr$", ("fsdp", None)),
    (r"tm/(a_[rkvgw]|aw)$", ("fsdp", None)),
    (r"tm/(b_[rkvgw]|bw)$", (None, "fsdp")),
    (r"rec/(win|wgate)$", ("fsdp", "lru")),
    (r"rec/w[ri]$", (None, "lru")),
    (r"rec/conv_w$", (None, "lru")),
    (r"rec/wout$", ("lru", "fsdp")),
    (r"protein/.*", None),
]


def param_spec(path_str: str, shape, mesh, cfg, mode: str = "train"):
    """mode="train": FSDP storage (gather-at-use) for big archs.
    mode="serve": decode-time 2D tensor sharding — there is no optimizer
    state to co-shard, and per-step FSDP weight gathers dwarf the one-token
    compute. Instead the would-be-FSDP dim shards over ``data`` as a
    second tensor axis."""
    ndim = len(shape)
    if mode == "serve" and re.search(r"moe/w[igo]$", path_str):
        # serve-time experts are stationary: huge experts (ep mode) 2D
        # (experts x data-on-f); small experts (fsdp mode) experts->model
        if getattr(cfg, "moe_parallelism", "ep") == "ep":
            logical = (None,) * (ndim - 3) + (
                ("experts", "data2d", None) if path_str.endswith("wo")
                else ("experts", None, "data2d"))
        else:
            logical = (None,) * (ndim - 3) + ("experts", None, None)
        return resolve_logical(logical, shape, mesh, cfg)
    # moe_parallelism="fsdp" (training): experts replicated at use, storage
    # sharded over the data axis only
    if (getattr(cfg, "moe_parallelism", "ep") == "fsdp"
            and re.search(r"moe/w[igo]$", path_str)):
        logical = (None,) * (ndim - 3) + (None, "fsdp", None)
        return resolve_logical(logical, shape, mesh, cfg)
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path_str):
            if logical is None:
                return ()
            logical = tuple(
                ("heads" if l == "heads_flat" else l) for l in logical)
            if mode == "serve":
                logical = tuple(("data2d" if l == "fsdp" else l)
                                for l in logical)
            # stacked segment params carry a leading repeats axis
            extra = ndim - len(logical)
            logical = (None,) * extra + logical
            return resolve_logical(logical, shape, mesh, cfg)
    return ()  # norms, biases, 1-D params: replicated


def _leaves(tree, path=()):
    """(path string, leaf) pairs of a tree of dicts and lists (anything
    else, a tuple too, is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def param_paths(module):
    """Each parameter of ``module`` (an LM, ProGen or FoldScore) by its port
    name: (the reference's path string, the reference's shape, whether the
    reference stacks it on a leading repeats axis)."""
    from repro_torch.bridge import ref_tree
    names = {id(p): n for n, p in module.named_parameters()}
    tree = ref_tree(module, leaf=lambda ts, stacked: (tuple(ts), stacked))
    out = {}
    for path, (tensors, stacked) in _leaves(tree):
        # a leaf drawn as the rank's rows only keeps its whole shape
        shape = tuple(getattr(tensors[0], "whole_shape", tensors[0].shape))
        if stacked:
            shape = (len(tensors),) + shape
        for t in tensors:
            out[names[id(t)]] = (path, shape, stacked)
    return out


def _drop_repeats(spec, ndim, stacked):
    """A reference spec padded to ``ndim`` dims, its repeats entry dropped
    from a stacked leaf's."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if stacked:
        if spec[0] is not None:
            raise ValueError(f"spec {spec} shards the repeats axis")
        spec = spec[1:]
    return spec


def param_spec_tree(module, mesh, cfg, mode: str = "train"):
    """{port parameter name: spec}, each the reference's rule for the
    parameter's reference path and stacked shape, without the repeats
    entry; one entry a tensor dim."""
    return {name: _drop_repeats(param_spec(path, shape, mesh, cfg, mode),
                                len(shape), stacked)
            for name, (path, shape, stacked) in param_paths(module).items()}


# ---------------------------------------------------------------------------
# cache / activation specs
# ---------------------------------------------------------------------------


def cache_spec(path_str: str, shape, mesh, cfg):
    """KV caches (R,B,L,KV,hd), ssm states (R,B,...). Shard batch over dp,
    kv-head axis over model when divisible."""
    ndim = len(shape)
    if path_str.endswith("pos"):
        return ()
    if re.search(r"/(k|v)$", path_str) and ndim >= 4:
        # (..., B, L, KV, hd): shard KV heads over model when divisible,
        # else fall back to sharding head_dim
        logical = [None] * ndim
        logical[-4] = "batch"
        logical[-2] = "kv_heads"
        spec = resolve_logical(tuple(logical), shape, mesh, cfg)
        if spec[-2] is None:
            logical[-2] = None
            logical[-1] = "model"
            spec = resolve_logical(tuple(logical), shape, mesh, cfg)
        return spec
    if path_str.endswith("S") and ndim >= 3:  # rwkv state (R,B,H,K,K)
        logical = [None] * ndim
        logical[-4] = "batch"
        logical[-3] = "heads"
        return resolve_logical(tuple(logical), shape, mesh, cfg)
    if re.search(r"/(h|conv|shift_tm|shift_cm)$", path_str):
        logical = [None] * ndim
        # batch is the leading post-repeats axis
        logical[1 if ndim > 1 else 0] = "batch"
        if path_str.endswith(("h", "conv")):
            logical[-1] = "lru"
        return resolve_logical(tuple(logical), shape, mesh, cfg)
    return ()


def cache_spec_tree(caches, mesh, cfg):
    """Specs mirroring the port's per-layer caches (``lm.init_caches``: one
    dict a layer), each the reference's rule for the layer's path in its
    segment cache (``"{segment}/{i}_{kind}/..."``) and the shape stacked on
    the segment's repeats, without the repeats entry. A ``dec_attn``
    layer's fresh cache is its self-attention cache alone (its prefill adds
    ``{"self", "cross"}``): the reference's ``self/`` entry."""
    where = [(s, i, kind, reps) for s, (kinds, reps) in enumerate(cfg.segments)
             for _ in range(reps) for i, kind in enumerate(kinds)]
    return [layer_cache_specs(cache, kind, mesh, cfg, f"{s}/{i}", reps)
            for (s, i, kind, reps), cache in zip(where, caches)]


def layer_cache_specs(cache, kind, mesh, cfg, where="0/0", reps=1):
    """``cache_spec_tree``'s specs of one layer's cache, the layer at
    reference path ``{where}_{kind}`` in a segment of ``reps`` repeats (the
    rules read neither)."""
    specs = {}
    fresh = kind == "dec_attn" and "self" not in cache
    for path, leaf in _leaves(cache):
        shape = (reps,) + tuple(leaf.shape)
        ref = f"{where}_{kind}/{'self/' * fresh}{path}"
        spec = cache_spec(ref, shape, mesh, cfg)
        _put(specs, path.split("/"), _drop_repeats(spec, len(shape), True))
    return specs


def shard_shape(shape, spec, mesh):
    """The shape of one rank's shard of a tensor of ``shape`` placed by
    ``spec``: each dim over the product of the axes that shard it (the
    rules shard only dims that divide)."""
    sizes = _axes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // int(np.prod([sizes[a] for a in axes or ()]))
                 for n, axes in zip(shape, spec))


def local_cache(cache, kind, mesh, cfg, rows, device=None):
    """Zeros at this rank's shard of one layer's fresh ``cache`` (its
    shapes; on ``meta`` it costs nothing) as ``layer_cache_specs`` places
    it, with ``rows`` batch rows: the leading dim of every cache leaf is
    the batch, which the caller has split already."""
    out = {}
    for (path, leaf), (_, spec) in zip(_leaves(cache),
                                       _leaves(layer_cache_specs(
                                           cache, kind, mesh, cfg))):
        shape = (rows,) + shard_shape(leaf.shape, spec, mesh)[1:]
        _put(out, path.split("/"), torch.zeros(shape, dtype=leaf.dtype,
                                               device=device))
    return out


def _put(tree, keys, value):
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def batch_spec(mesh, cfg=None):
    return (dp_axes(mesh),)


def tokens_sharding(mesh, shape):
    """(B, S) int tokens: shard batch over dp axes when divisible; the
    spec (``()`` replicated)."""
    if shape[0] % dp_size(mesh) == 0:
        return (dp_axes(mesh),)
    return ()


# ---------------------------------------------------------------------------
# DTensor storage on a torch DeviceMesh
# ---------------------------------------------------------------------------


def placements(spec, mesh):
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim: a
    tensor dim sharded over axes gets ``Shard(dim)`` on each of them (in the
    mesh's order, JAX's major-to-minor, so a rank holds the chunk the
    reference's device holds), every other mesh dim ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(axis_names(mesh))
    index = {a: i for i, a in enumerate(axis_names(mesh))}
    for dim, axes in enumerate(spec):
        for a in axes or ():
            out[index[a]] = Shard(dim)
    return out


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (without importing DTensor's module,
    which takes a second: no DTensor exists before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local(t):
    """A DTensor's local shard, a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def whole(t):
    """A DTensor gathered into one plain tensor (every rank takes part), a
    plain tensor as it is; no gradient flows back."""
    return t.detach().full_tensor() if is_dtensor(t) else t


def _owner(module, name):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def shard_module(module, mesh, cfg, mode: str = "train"):
    """Make each parameter of ``module`` a DTensor with its spec's
    placements (``param_spec_tree``), in place; returns {name:
    placements}."""
    pl = {name: placements(spec, mesh)
          for name, spec in param_spec_tree(module, mesh, cfg, mode).items()}
    distribute_params(module, {n: (mesh, p) for n, p in pl.items()})
    return pl


def distribute_params(module, where):
    """Replace each parameter named in ``where`` ({name: (mesh,
    placements)}) by a DTensor parameter of that layout, in place. Every
    rank holds the same full weights (drawn from one seed or read from one
    checkpoint), so each keeps its own chunk and nothing is sent; a
    parameter drawn as the rank's rows of its leading axis only
    (``whole_shape``, ``moe.local_experts``) holds that dim's chunk
    already, and keeps its chunk of the other dims."""
    from torch import nn
    from torch.distributed.tensor import DTensor, distribute_tensor
    for name, (mesh, pl) in where.items():
        owner, leaf = _owner(module, name)
        p = getattr(owner, leaf)
        whole = getattr(p, "whole_shape", None)
        if whole is not None:
            setattr(owner, leaf, nn.Parameter(
                _from_rows(p.detach(), whole, mesh, pl),
                requires_grad=p.requires_grad))
            continue
        d = distribute_tensor(p.detach(), mesh, pl, src_data_rank=None)
        chunk = d.to_local()
        if chunk.untyped_storage().nbytes() > chunk.numel() \
                * chunk.element_size():
            # a chunk that views the whole: give it storage of its own
            d = DTensor.from_local(chunk.clone(), mesh, pl, shape=d.shape,
                                   stride=d.stride())
        setattr(owner, leaf, nn.Parameter(d, requires_grad=p.requires_grad))


def _from_rows(rows, whole, mesh, pl):
    """The DTensor of shape ``whole`` and placements ``pl`` whose leading
    dim this rank holds ``rows`` of (its chunk along that dim); the other
    sharded dims are cut to the rank's chunk here."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    n0 = 1
    for i, p in enumerate(pl):
        if p.is_shard(0):
            n0 *= mesh.size(i)
        elif p.is_shard():
            rows = rows.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    if rows.shape[0] * n0 != whole[0]:
        raise ValueError(f"{rows.shape[0]} rows of {whole[0]} do not make "
                         f"the chunk of {pl}")
    stride = tuple(int(np.prod(whole[i + 1:])) for i in range(len(whole)))
    return DTensor.from_local(rows.contiguous().clone(), mesh, pl,
                              shape=torch.Size(whole), stride=stride)


def expert_rows(mesh, cfg, mode: str = "train"):
    """This rank's rows of the expert axis as ``mode``'s rules store the
    MoE experts on ``mesh`` (a slice), or None where the rules do not
    shard that axis (or the config has no experts): what
    ``moe.local_experts`` draws."""
    E = getattr(cfg, "moe_experts", 0)
    if not E:
        return None
    spec = param_spec("moe/wi", (E, cfg.d_model, cfg.moe_d_ff), mesh, cfg,
                      mode)
    axes = spec[0] if spec else None
    if not axes:
        return None
    sizes = _axes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    index = 0
    for a in axes:
        index = index * sizes[a] + coord[a]
    n = E // int(np.prod([sizes[a] for a in axes]))
    return slice(index * n, (index + 1) * n)


# one count a gathered use of a DTensor parameter (an all-gather over the
# mesh dims that shard it) and one a use's gradient reduction (a
# reduce-scatter over those dims, an all-reduce over the others); a mesh dim
# of one rank sends nothing. "over_model": the uses that gather a parameter
# sharded over a ``model`` axis of more than one rank across it
gathers = {"uses": 0, "reductions": 0, "over_model": 0}
_gather_lock = threading.Lock()


def _count(key):
    with _gather_lock:
        gathers[key] += 1


class _Counted(torch.autograd.Function):
    """The identity, counting the gradient reduction its backward stands
    for."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count("reductions")
        return g


def gather(w, dtype, use: str = "local"):
    """DTensor parameter ``w`` as one plain tensor of ``dtype``; the local
    shard is cast first, so the collectives move ``dtype`` bytes.

    Outside a tensor-parallel step (``tp``) all of ``w``, its gradient taken
    as a partial sum on every rank (``Partial`` on each mesh dim): the
    backward reduce-scatters it onto the shard (all-reduces it where ``w``
    is replicated). In a serve step, the rank's shard as it is stored:
    along ``model`` as ``"local"`` and ``"partial"`` take it (the rules
    shard the one and replicate the other), along ``data`` its
    ``"data2d"`` slice, which ``dot`` multiplies where it lies; only
    ``"whole"`` gathers all of it. In a train step, ``w`` is gathered over
    the dp axes only (its
    gradient a partial sum there) and along ``model`` ``use`` says what the
    layer takes: ``"local"`` the rank's shard of a parameter sharded over
    ``model`` (all of a replicated one), its gradient that shard's whole
    gradient; ``"whole"`` all of it, every ``model`` rank using it alike
    (the same gradient on each); ``"partial"`` all of it, each rank using
    its own part (the gradient summed over ``model``)."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = w.device_mesh
    t = tp()
    if _over_model(w, t, use):
        _count("over_model")
    if t.mesh is None:
        full = w.to(dtype).full_tensor(grad_placements=[Partial()]
                                       * mesh.ndim)
    elif t.mode == "serve" and use != "whole":
        full = w.to(dtype).to_local()
    else:
        target, grads = [], []
        for axis, pl in zip(axis_names(mesh), w.placements):
            if axis != "model":
                target.append(Replicate())
                grads.append(Partial())
            elif use == "local":
                target.append(pl)
                grads.append(pl)
            else:
                target.append(Replicate())
                grads.append(Partial() if use == "partial" else Replicate())
        full = w.to(dtype).redistribute(mesh, target).to_local(
            grad_placements=grads)
    _count("uses")
    return _Counted.apply(full) if full.requires_grad else full


def _over_model(w, t, use) -> bool:
    """Whether ``gather(w, ..., use)`` in the step ``t`` gathers ``w``
    across a ``model`` axis of more than one rank that shards it."""
    names = axis_names(w.device_mesh)
    if "model" not in names:
        return False
    i = names.index("model")
    if w.device_mesh.size(i) == 1 or not w.placements[i].is_shard():
        return False
    if t.mesh is None:
        return True
    return use == "whole" or (t.mode == "train" and use != "local")


# ---------------------------------------------------------------------------
# tensor-parallel compute over ``model``
# ---------------------------------------------------------------------------


class TP(NamedTuple):
    """This rank's place along ``model`` in a tensor-parallel step: its
    index, the axis' size, the step's mesh (None off one), the axis'
    process group and the step's mode ("train" or "serve")."""
    rank: int
    size: int
    mesh: object
    group: object
    mode: str = "train"


_OFF = TP(0, 1, None, None)


def tp() -> TP:
    """The tensor-parallel step in force: the innermost
    ``activation_sharding`` of this thread when it is a train-mode or
    serve-mode ``DeviceMesh`` with a ``model`` axis, else rank 0 of 1 with
    no mesh."""
    stack = _stack()
    if not stack:
        return _OFF
    mesh, _, mode, _ = stack[-1]
    names = axis_names(mesh)
    if mode not in ("train", "serve") or "model" not in names \
            or not hasattr(mesh, "get_group"):
        return _OFF
    dim = names.index("model")
    return TP(mesh.get_local_rank(dim), mesh.size(dim), mesh,
              mesh.get_group(dim), mode)


def split_lo(w, dim: int):
    """The first index along tensor dim ``dim`` of this rank's shard of
    parameter ``w`` when the step is tensor-parallel over more than one
    rank and ``w`` is sharded over ``model`` on that dim, else None (the
    layer sees all of it)."""
    t = tp()
    if t.size == 1 or not is_dtensor(w):
        return None
    pl = w.placements[axis_names(w.device_mesh).index("model")]
    if not pl.is_shard(dim):
        return None
    return t.rank * (w.shape[dim] // t.size)


def rank_slice(n: int) -> slice:
    """This rank's contiguous share of an axis of ``n`` entries split over
    ``model`` (a DTensor shard's rows: chunk ``rank`` of ``size``)."""
    t = tp()
    k = n // t.size
    return slice(t.rank * k, (t.rank + 1) * k)


def _all_reduce(x, group, op="sum"):
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(x.contiguous(), op, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gathered(x, dim, group, rank, size):
    """Every ``model`` rank's ``x`` along ``dim``, in rank order: the rank's
    ``x`` in a zeroed buffer, all-reduced (exact: one rank's value and
    zeros)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    buf = x.new_zeros(shape)
    buf.narrow(dim, rank * n, n).copy_(x)
    return _all_reduce(buf, group)


class _GatherFromModel(torch.autograd.Function):
    """Gather along ``dim``; the gradient's chunk kept (no sum)."""

    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.part = (dim, rank * x.shape[dim], x.shape[dim])
        return _gathered(x, dim, group, rank, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.part), None, None, None, None


class _GatherSeq(torch.autograd.Function):
    """Gather along the sequence (dim 1); the gradient summed over
    ``model``, the chunk kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.part = group, (1, rank * x.shape[1], x.shape[1])
        return _gathered(x, 1, group, rank, size)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.group).narrow(*ctx.part).contiguous(),
                None, None, None)


class _ScatterSeq(torch.autograd.Function):
    """The sum over ``model`` (where ``reduce``) and the rank's chunk of
    the sequence (dim 1); the gradient's chunks gathered."""

    @staticmethod
    def forward(ctx, x, group, rank, size, reduce):
        ctx.group, ctx.rank, ctx.size = group, rank, size
        n = x.shape[1] // size
        if reduce:
            x = _all_reduce(x, group)
        return x.narrow(1, rank * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return (_gathered(g, 1, ctx.group, ctx.rank, ctx.size), None, None,
                None, None)


def copy_to_model(x):
    """Before a column-parallel product: ``x`` as it is, its gradient
    all-reduced over ``model`` (each rank's product gives only its columns'
    share of it)."""
    t = tp()
    return x if t.size == 1 else _CopyToModel.apply(x, t.group)


def reduce_from_model(x):
    """After a row-parallel product: the sum of every ``model`` rank's
    partial ``x`` (an all-reduce), its gradient passed on as it is."""
    t = tp()
    return x if t.size == 1 else _ReduceFromModel.apply(x, t.group)


def max_over_model(x):
    """The elementwise max of ``x`` over the ``model`` ranks, no gradient."""
    t = tp()
    return x if t.size == 1 else _all_reduce(x.detach(), t.group, "max")


def gather_from_model(x, dim: int = -1):
    """Every ``model`` rank's slice of dim ``dim`` (the last by default), in
    rank order: each rank's ``x`` written into a zeroed full-width buffer
    and the buffers all-reduced, which is exact (one rank's value and
    zeros). Its backward takes the rank's slice of the gradient, so the
    gradient must be the same on every rank: put ``copy_to_model`` after it
    where each rank's use differs."""
    t = tp()
    return x if t.size == 1 else _GatherFromModel.apply(
        x, t.group, t.rank, t.size, dim % x.dim())


def gather_seq(x):
    """Sequence parallelism's gather before a column-parallel block: every
    ``model`` rank's chunk of the sequence (dim 1 of ``x``), in rank order
    (an all-gather, made as ``gather_from_model`` makes one). Its backward
    is a reduce-scatter: each rank's product gives only its columns' share
    of the gradient, so the gradients are summed over ``model`` (an
    all-reduce) and the rank keeps its chunk."""
    t = tp()
    return x if t.size == 1 else _GatherSeq.apply(x, t.group, t.rank,
                                                  t.size)


def scatter_seq(x, reduce: bool = True):
    """Sequence parallelism's reduce-scatter after a row-parallel block:
    the sum of every ``model`` rank's partial ``x`` (an all-reduce), of
    which the rank keeps its chunk of the sequence (dim 1); with ``reduce``
    False, the rank's chunk of an ``x`` that every rank holds whole. Its
    backward gathers the gradient's chunks (``gather_seq``'s forward), so
    each rank's block sees the gradient of every position."""
    t = tp()
    return x if t.size == 1 else _ScatterSeq.apply(x, t.group, t.rank,
                                                   t.size, reduce)


# ---------------------------------------------------------------------------
# serving on the serve rules' 2-D shards: the "data2d" products
# ---------------------------------------------------------------------------


class Data2d(NamedTuple):
    """This rank's place along ``data`` in a serve step: its index, the
    axis' size, its process group, and whether each ``data`` rank holds
    rows of its own (``activation_sharding``'s ``split_rows``)."""
    rank: int
    size: int
    group: object
    split_rows: bool


def data2d() -> Optional[Data2d]:
    """The ``data`` axis of the serve step in force, where it has more than
    one rank; None elsewhere (a train step, no mesh, one ``data`` rank: a
    ``"data2d"`` shard is then all of the dim, and nothing moves)."""
    t = tp()
    if t.mode != "serve" or "data" not in axis_names(t.mesh):
        return None
    dim = axis_names(t.mesh).index("data")
    if t.mesh.size(dim) == 1:
        return None
    return Data2d(t.mesh.get_local_rank(dim), t.mesh.size(dim),
                  t.mesh.get_group(dim), _stack()[-1][3])


def rows_over_data(x):
    """Every ``data`` rank's rows of ``x`` (its leading dim), in rank order:
    each rank's rows written into a zeroed buffer and the buffers
    all-reduced over ``data`` (exact: one rank's value and zeros); ``x``
    as it is where the ranks hold the same rows or there is no serve
    step."""
    d = data2d()
    if d is None or not d.split_rows:
        return x
    n = x.shape[0]
    buf = x.new_zeros((n * d.size,) + tuple(x.shape[1:]))
    buf[d.rank * n:(d.rank + 1) * n] = x
    return _all_reduce(buf, d.group)


def own_rows(y, n: int):
    """This ``data`` rank's ``n`` rows of ``y``, ``rows_over_data``'s
    rows."""
    d = data2d()
    if d is None or not d.split_rows:
        return y
    return y[d.rank * n:(d.rank + 1) * n]


def columns_over_data(y, dim: int = -1):
    """Every ``data`` rank's columns of ``y`` along ``dim`` (its
    ``"data2d"`` slice of an output dim), in rank order: written into a
    zeroed full-width buffer, all-reduced over ``data``."""
    d = data2d()
    if d is None:
        return y
    k = y.shape[dim]
    shape = list(y.shape)
    shape[dim] = k * d.size
    buf = y.new_zeros(shape)
    buf.narrow(dim, d.rank * k, k).copy_(y)
    return _all_reduce(buf, d.group)


def _data_dim(w):
    """The tensor dim of parameter ``w`` that is stored sharded over
    ``data`` (its ``"data2d"`` dim under the serve rules), else None."""
    if not is_dtensor(w):
        return None
    names = axis_names(w.device_mesh)
    if "data" not in names:
        return None
    pl = w.placements[names.index("data")]
    return pl.dim if pl.is_shard() else None


def _axis(subscripts: str, letter: str) -> int:
    """The (negative) dim of ``letter`` in one operand's einsum subscripts
    (an ellipsis only in front)."""
    tail = subscripts.split("...")[-1]
    return tail.index(letter) - len(tail)


_MATMUL, _MATMUL_T = "...i,io->...o", "...i,oi->...o"


def dot(x, w, used, eq: str = _MATMUL):
    """The product of activation ``x`` and parameter ``w`` as the layer uses
    it (``used``: ``common.at_use`` / ``cast``'s result): ``x @ used`` by
    default, ``x @ used.T`` for ``"...i,oi->...o"``, else
    ``torch.einsum(eq, x, used)``.

    In a serve step (``data2d``) a parameter stored sharded over ``data``
    stays where it is and the activations move: the token rows are
    gathered over ``data`` (``rows_over_data``), multiplied by the rank's
    ``"data2d"`` slice, and then, where that dim is contracted (``wq``,
    ``w[kvig]``, ``tm/w[rkvg]``, ``rec/win``, ``lm_head/w``, ...), the
    partial products are summed over ``data``, and where it is an output
    dim (``attn/wo``, ``mlp/wo``, ``tm/wo``, ``rec/wout``, the mixing
    LoRAs' ``b_*``), the rank's columns are summed into a zeroed
    full-width buffer (``columns_over_data``); the rank keeps its own rows
    (``own_rows``). Two all-reduces a product, no gather of a weight. On
    one ``data`` rank, in a train step, off a mesh, and for a ``used``
    that is all of the dim (a weight gathered whole), the product as it
    is."""
    def product(a):
        if eq == _MATMUL:
            return a @ used
        if eq == _MATMUL_T:
            return a @ used.T
        return torch.einsum(eq, a, used)
    d = data2d()
    j = None if d is None else _data_dim(w)
    if j is None or used.shape[j] == w.shape[j]:
        return product(x)
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    c = ws.split("...")[-1][j - used.dim()]
    xa = rows_over_data(x)
    k = used.shape[j]
    if c in out:
        y = columns_over_data(product(xa), _axis(out, c))
    else:
        y = _all_reduce(product(xa.narrow(_axis(xs, c), d.rank * k, k)),
                        d.group)
    return own_rows(y, x.shape[0])


# ---------------------------------------------------------------------------
# the MoE region: expert parallelism
# ---------------------------------------------------------------------------


class MoeSplit(NamedTuple):
    """How the MoE region of the step in force splits (``moe_split``):
    whether each ``model`` rank routes and computes only its share of the
    groups (``groups``: the groups over the dp axes and ``model``), only
    its ``E / model`` experts (``experts``), and, in a serve step, only its
    ``f / data`` slice of their hidden width (``f_data``)."""
    groups: bool = False
    experts: bool = False
    f_data: bool = False


def moe_split(cfg, n_groups: int, n_experts: int, d_ff: int) -> MoeSplit:
    """The split of a capacity-form MoE over ``n_groups`` groups (this
    rank's: the dp ranks' rows are split already where ``split_rows``)
    with ``n_experts`` experts of hidden width ``d_ff``, by the
    reference's constraints (``repro.models.moe._moe_fwd_capacity``)
    resolved through ``resolve_logical``: the groups over
    ``"expert_group"`` (the dp axes) with ``moe_parallelism="ep"``, over
    ``"expert_group_all"`` (dp and ``model``, falling back to dp where
    the groups do not divide both) otherwise, and not at all in an
    ``"ep"`` serve step (its dispatch is gathered over ``data``); the
    experts over ``"experts"`` (``model``) with ``"ep"`` and in every
    serve step; ``f`` over ``"data2d"`` in an ``"ep"`` serve step.

    Where the reference would name ``model`` twice (a serve step of a
    non-``"ep"`` config whose groups divide dp x ``model``: its spec
    ``P(("data", "model"), "model", None, None)`` raises
    ``DuplicateSpecError`` in JAX), the experts stay on ``model``, where
    the serve rules store them, and the groups take the dp axes only, as
    the reference resolves them where it runs (qwen3-moe-30b-a3b at
    ``decode_32k``, whose 128 groups do not divide 256 devices). Off a
    tensor-parallel step, or on a ``model`` axis of one rank, nothing
    splits over ``model``; ``f_data`` needs more than one ``data`` rank
    (``data2d``)."""
    t = tp()
    if t.mesh is None:
        return MoeSplit()
    ep = getattr(cfg, "moe_parallelism", "ep") == "ep"
    serve = t.mode == "serve"
    gax = "expert_group" if ep else "expert_group_all"
    logical = (None if serve and ep else gax,
               "experts" if ep or serve else None,
               "data2d" if serve and ep else None)
    rows = dp_size(t.mesh) if _stack()[-1][3] else 1
    g, e, f = resolve_logical(logical, (n_groups * rows, n_experts, d_ff),
                              t.mesh, cfg)
    if g and e and "model" in g and "model" in e:
        g = _fit(n_groups * rows, dp_axes(t.mesh), t.mesh)
    return MoeSplit(groups=t.size > 1 and "model" in (g or ()),
                    experts=t.size > 1 and e is not None,
                    f_data=f is not None and data2d() is not None)


class _AllToAll(torch.autograd.Function):
    """Block j of dim 0 to ``model`` rank j; the gradient sent back the
    same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_to_all_single(x.contiguous(), None, None, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def all_to_all_model(x):
    """An all-to-all over ``model``: ``x``'s dim 0 is ``model`` blocks, of
    which block j goes to rank j; the result's block i is what rank i
    sent this rank. Its backward is the same exchange of the gradient.
    gloo completes it for CUDA tensors (``tools/gloo_cuda_probe.py``), so
    it is the collective itself, not a stand-in."""
    t = tp()
    return x if t.size == 1 else _AllToAll.apply(x, t.group)


class _GradOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def grad_once(x):
    """``x`` as it is, its gradient passed on by ``model`` rank 0 only:
    for a value every rank computes alike from inputs whose gradients are
    summed over ``model`` (``copy_to_model``, ``gather_seq``, a
    ``use="partial"`` weight), so that it enters them once, not once a
    rank (the MoE's aux values under expert parallelism)."""
    t = tp()
    return x if t.size == 1 else _GradOnce.apply(x, t.rank == 0)


def sum_over_data(x):
    """The sum of every ``data`` rank's partial ``x`` in a serve step
    (``data2d``): a product over a ``"data2d"`` slice of a contracted dim;
    ``x`` as it is elsewhere."""
    d = data2d()
    return x if d is None else _all_reduce(x, d.group)


def dp_size(mesh) -> int:
    """Ranks along the dp axes: how many ways the batch is split."""
    return int(np.prod([_axes(mesh)[a] for a in dp_axes(mesh)]))


def dp_index(mesh):
    """(this rank's index along the dp axes, major-to-minor, their size)."""
    sizes = _axes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    index, size = 0, 1
    for a in dp_axes(mesh):
        index, size = index * sizes[a] + coord[a], size * sizes[a]
    return index, size


def local_rows(batch, mesh):
    """This rank's rows of a global batch dict, as ``tokens_sharding``
    shards them: a 1/dp slice of each tensor's leading axis, or all of it
    where the rows do not divide."""
    n = next(iter(batch.values())).shape[0]
    if not tokens_sharding(mesh, (n,)):
        return dict(batch)
    i, size = dp_index(mesh)
    rows = n // size
    return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
