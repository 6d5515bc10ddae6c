"""FLOP, byte and collective accounting of a PyTorch step: the counterpart
of the JAX package's ``repro.distributed.hlo_cost``.

The reference walks compiled HLO; the port has no compiled program, so
``Counter`` is a ``TorchDispatchMode`` that counts each aten op as it runs,
on local tensors (a DTensor operand counts its local shard: each rank's own
work, as the reference's post-SPMD module holds it). The reference's
conventions:

  flops     dot = 2·|result|·|contracted|; elementwise and transcendental
            = |result|; reduce = |operand|; data movement = 0.
  bytes     operand + result bytes per op; views are free, gathers and
            scatters count the touched bytes (2·|result|, 2·|update|).
  coll      collectives (``_c10d_functional`` all-gather, reduce-scatter,
            all-reduce, all-to-all, and ``c10d``'s in-place all-reduce):
            result bytes per device, by kind (``Counter.calls`` counts
            them). A tensor-parallel step's all-reduces are the
            functional ones of ``distributed.sharding``.

Each kernel counts by a formula over its shapes, whatever implements it:
the wrappers in ``kernels/`` report ``flash_work``, ``wkv6_work``,
``wkv6_bwd_work`` (``WKV6``'s backward), ``rglru_work`` or ``paged_work``
through ``counted`` and the counter ignores the aten ops inside, so the
CUDA kernel and its plain version count the same work. ``chip_smoke.py``'s
bounds read the same formulas. On the ``meta`` device the wrappers return
correctly shaped outputs and report their formula: the dry-run path
(``launch/dryrun.py``).

Regions are tagged by ``tag`` (``flashattn`` around attention's kernel,
``wkvscan`` / ``rgscan`` around the scans, ``moeffn`` around the MoE
capacity form, the names ``dryrun.py`` selects, as the reference's
``named_scope``s); the Functions' backwards re-enter their tag.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.distributed.sharding import local


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        for k, v in o.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v
        return self

    def scaled(self, n: float) -> "Cost":
        return Cost(self.flops * n, self.bytes * n,
                    {k: v * n for k, v in self.coll.items()})

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())


# ---------------------------------------------------------------------------
# kernel formulas (also chip_smoke.py's bounds)
# ---------------------------------------------------------------------------


def _live_ranges(Sq, Sk, causal, window, q_offset=0):
    """Each query's live keys [lo, hi] (inclusive; empty where hi < lo),
    query r at position r + ``q_offset``, keys indexed from 0."""
    r = np.arange(Sq, dtype=np.int64) + q_offset
    lo = np.maximum(0, r - window + 1) if window > 0 else np.zeros_like(r)
    hi = np.minimum(r, Sk - 1) if causal else np.full_like(r, Sk - 1)
    return lo, hi


def live_pairs(Sq, Sk, causal, window, q_offset=0):
    """(q, k) pairs a mask leaves live, query r at position r +
    ``q_offset`` (a context-parallel rank's chunk), keys indexed from 0."""
    lo, hi = _live_ranges(Sq, Sk, causal, window, q_offset)
    return int(np.maximum(0, hi - lo + 1).sum())


def live_keys(Sq, Sk, causal, window, q_offset=0):
    """Keys from the first that some query reads to the last: the K/V rows
    a call must load (a chunk at an offset reads none past its last
    position)."""
    lo, hi = _live_ranges(Sq, Sk, causal, window, q_offset)
    live = hi >= lo
    return int(hi[live].max() - lo[live].min() + 1) if live.any() else 0


def flash_work(B, H, KV, Sq, Sk, hd, q_elem, kv_elem, causal=True,
               window=0, q_offset=0):
    """(flops, bytes) of attention over ``Sk`` live keys, query row 0 at
    position ``q_offset``: 2·hd for QKᵀ and 2·hd for PV a live pair; q
    read and the output written in q's dtype, K and V read once over the
    keys some query reads (``live_keys``)."""
    flops = 4 * hd * B * H * live_pairs(Sq, Sk, causal, window, q_offset)
    keys = live_keys(Sq, Sk, causal, window, q_offset)
    return flops, (2 * B * H * Sq * hd * q_elem
                   + 2 * B * KV * keys * hd * kv_elem)


def flash_bwd_work(B, H, KV, Sq, Sk, hd, q_elem, kv_elem, causal=True,
                   window=0, q_offset=0):
    """(flops, bytes) of attention's gradient over the live pairs: 10·hd a
    live pair (the scores recomputed, then dV, dP, dQ and dK, 2·hd each);
    q, the output and its gradient read and dq written in q's dtype, K and
    V read and dK and dV written once over the keys some query reads.
    ``chip_smoke.py``'s bound of the plain backward."""
    flops = 10 * hd * B * H * live_pairs(Sq, Sk, causal, window, q_offset)
    keys = live_keys(Sq, Sk, causal, window, q_offset)
    return flops, (4 * B * H * Sq * hd * q_elem
                   + 4 * B * KV * keys * hd * kv_elem)


def wkv6_work(B, H, T, K, elem):
    """(flops, bytes) of one wkv6 call: two fp32 multiply-adds a state
    element a token (the output and the state update); r/k/v read and y
    written in the compute dtype, logw read in fp32, u read, s0 read and
    s_T written in fp32."""
    n = B * H * T * K
    return (4 * B * H * T * K * K,
            4 * n * elem + 4 * n + 4 * H * K + 2 * 4 * B * H * K * K)


def wkv6_bwd_work(B, H, T, K, elem):
    """(flops, bytes) of one wkv6 gradient call: six fp32 multiply-adds a
    state element a token (the state rebuilt, G's update, and the dr, dk,
    dv and dlogw sums); r/k/v/dy read and dr/dk/dv written in the compute
    dtype, logw read and dlogw written in fp32, u read and du written, s0
    and dS read and ds0 written in fp32. The kernel's checkpoints and
    partial sums are its own traffic and not counted."""
    n = B * H * T * K
    return (12 * B * H * T * K * K,
            7 * n * elem + 2 * 4 * n + 2 * 4 * H * K + 3 * 4 * B * H * K * K)


def rglru_work(B, T, C):
    """(flops, bytes) of one rglru call: a multiply and an add an element;
    a, b read and h written, h0 read and h_T written, all fp32."""
    return 2 * B * T * C, 4 * (3 * B * T * C + 2 * B * C)


def rglru_bwd_work(B, T, C):
    """(flops, bytes) of one rglru gradient call: the reverse recurrence's
    multiply and add and da's product an element; a, h and gh read and da,
    db written, h0 and gT read and dh0 written, all fp32."""
    return 3 * B * T * C, 4 * (5 * B * T * C + 3 * B * C)


def paged_work(B, KV, G, hd, live, maxp, elem):
    """(flops, bytes) of one paged decode over ``live`` cached tokens: 4·hd
    a (query head, token); q read and the output written, the live tokens'
    K and V read, the block tables and lengths (int32) read."""
    return (4 * hd * G * KV * live,
            (2 * B * KV * G * hd + 2 * live * KV * hd) * elem
            + (B * maxp + B) * 4)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_ACTIVE: list = []       # counters in scope, innermost last

_DOTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1,
         "addbmm": 1, "addmv": 1}
_REDUCES = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
            "std", "var_mean", "std_mean", "logsumexp", "norm",
            "linalg_vector_norm", "argmax", "argmin", "any", "all",
            "_softmax", "_log_softmax", "cumsum"}
_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "index_add": 3, "index_add_": 3,
             "embedding_dense_backward": 0}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
                "allreduce_": "all-reduce", "allgather_": "all-gather",
                "reduce_scatter_": "reduce-scatter", "alltoall_": "all-to-all"}
_COPIES = {"clone"}       # data movement, though tagged pointwise
_POINTWISE = getattr(torch.Tag, "pointwise", None)
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _tensors(x):
    return [local(t) for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(ts):
    return float(sum(t.numel() * t.element_size() for t in ts))


def _is_view(func):
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def op_cost(func, args, kwargs, out) -> Cost:
    """One aten op's cost on local tensors, by the conventions above."""
    name = func.overloadpacket.__name__
    if func.namespace in ("_c10d_functional", "c10d_functional", "c10d"):
        kind = _COLLECTIVES.get(name)
        return Cost(coll={kind: _nbytes(_tensors(out))}) if kind else Cost()
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if _is_view(func) or not outs:
        return Cost()
    n_out = float(sum(t.numel() for t in outs))
    if name in _GATHERS:
        return Cost(0.0, 2.0 * _nbytes(outs))
    if name in _SCATTERS:
        upd = _tensors(args[_SCATTERS[name]]) if len(args) > \
            _SCATTERS[name] else outs
        return Cost(0.0, 2.0 * _nbytes(upd))
    nbytes = _nbytes(ins) + _nbytes(outs)
    if name in _DOTS:
        lhs = local(args[_DOTS[name]])
        return Cost(2.0 * n_out * lhs.shape[-1], nbytes)
    if name in _REDUCES or (_REDUCTION is not None and _REDUCTION in
                            func.tags):
        return Cost(float(ins[0].numel()) if ins else 0.0, nbytes)
    if name not in _COPIES and _POINTWISE is not None and \
            _POINTWISE in func.tags:
        return Cost(n_out, nbytes)
    return Cost(0.0, nbytes)


class Counter(TorchDispatchMode):
    """Counts every aten op run inside it (``op_cost``), by the stack of
    tags open at the op (``tag``); a kernel reports its formula
    (``counted``) and its own ops go uncounted."""

    def __init__(self):
        super().__init__()
        self.total = Cost()
        self.by_tags: Dict[tuple, Cost] = {}
        self.tags: list = []
        self.opaque = 0
        self.calls: Dict[str, int] = {}   # collectives called, by kind

    def add(self, c: Cost, tags=()):
        self.total += c
        key = tuple(self.tags) + tuple(tags)
        if key:
            self.by_tags.setdefault(key, Cost()).__iadd__(c)

    def select(self, tag_re: str) -> Cost:
        """The cost counted under any tag matching ``tag_re``."""
        pat = re.compile(tag_re)
        out = Cost()
        for key, c in self.by_tags.items():
            if any(pat.search(t) for t in key):
                out += c
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.opaque:
            c = op_cost(func, args, kwargs, out)
            for kind in c.coll:
                self.calls[kind] = self.calls.get(kind, 0) + 1
            self.add(c)
        return out


@contextlib.contextmanager
def counting():
    """A fresh ``Counter`` over the block."""
    c = Counter()
    _ACTIVE.append(c)
    try:
        with c:
            yield c
    finally:
        _ACTIVE.remove(c)


@contextlib.contextmanager
def tag(name: str):
    """Tag the ops of the block ``name`` in the active counter (none: a
    no-op)."""
    if not _ACTIVE:
        yield
        return
    c = _ACTIVE[-1]
    c.tags.append(name)
    try:
        yield
    finally:
        c.tags.pop()


@contextlib.contextmanager
def counted(name: str, formula):
    """A kernel call: report ``formula()`` = (flops, bytes) to the active
    counter under tag ``name`` and leave the block's aten ops (a plain
    version's, a meta output's) uncounted. No counter: a no-op, the formula
    not evaluated."""
    if not _ACTIVE or _ACTIVE[-1].opaque:
        yield
        return
    c = _ACTIVE[-1]
    c.opaque += 1
    try:
        flops, nbytes = formula()
        c.add(Cost(float(flops), float(nbytes)), (name,))
        yield
    finally:
        c.opaque -= 1


def analyze(fn, *args, tag=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a counter. Returns its Cost, or
    (Cost, the Cost under tags matching ``tag``) when ``tag`` is given, as
    ``hlo_cost.analyze`` does."""
    with counting() as c:
        fn(*args, **kwargs)
    return (c.total, c.select(tag)) if tag else c.total


def model_flops(cfg, kind: str, tokens: int) -> float:
    """Useful model FLOPs: 6·N·D in training, 2·N·D in serving, N the
    active parameters (``cfg.active_param_count``), D the tokens."""
    return (6 if kind == "train" else 2) * cfg.active_param_count() * tokens
