"""Device payload functions for IMPRESS tasks (port of the reference's
``core/payload.py``).

Task kinds, each run on the sub-mesh the executor granted:

``generate`` (ProteinMPNN analogue) — samples one pipeline's candidates by
  dense decoding (``progen_sample``), split across the sub-mesh's devices,
  each device's share from its own seed ``fold_in_seed(seed, i)``.
``generate_batch`` — a (rows, n, L) stack, one row per pipeline. Dense form:
  all rows of a device go through one ``progen_sample`` call, each row from
  its own generator seeded from the row's seed, so a row's samples do not
  depend on which rows share the batch. Masked form (per-row ``row_lens``):
  every row samples at the shared bucketed length, its log-likelihood is
  masked to its true length and its tokens truncated on the host. Paged
  form (``decode="paged"``): every (row, candidate) pair becomes one decode
  slot of a ``PagedDecodeEngine`` — token-by-token continuous batching over
  a paged KV cache, with live admission through the executor's
  ``AdmissionPort``; candidate ``c`` of a row seeded ``s`` samples from its
  own generator, seeded ``fold_in_seed(s, c)``.
``predict`` (AlphaFold analogue) — scores one candidate: at its exact
  length, or with ``seq_len`` padded to its length bucket and masked.
``predict_batch`` — scores a stack in one call per device; with per-row
  ``seq_lens`` the masked form pads the token dim to a length bucket and
  excludes pad positions from every metric.
``backbone_batch`` — perturbs each row's base backbone into ``m``
  candidates (per-row generators) and scores their fit to the row's target.
``finetune`` (``FinetunePayload``, the §V model-evolution trainer) — AdamW
  steps on the fitness-weighted NLL of accepted designs, then publishes the
  evolved generator as a new ``ParamStore`` version.

The batched kinds pad their batch dim to a ``BATCH_BUCKETS`` size (pad rows
repeat the last real row and are dropped before returning) and split the
padded stack across the sub-mesh's devices. Their coalesce rules
(``*_coalesce_rule``) let the executor fuse compatible queued tasks from
different pipelines into one device batch. Every task function but
``finetune`` enters ``torch.inference_mode()`` itself: the executor calls
it from worker threads, which a caller's grad mode does not reach.

Generator weights live in versioned ``ParamStore``s; sampling dispatches
snapshot (version, weights) once and tag results ``gen_version``. Param-set
namespaces (heterogeneous stages): a task picks its generator or scorer by
``payload["params"]`` (``add_generator`` / ``add_scorer`` /
``register_stages``); "default" is the original pair, and a namespace the
payload does not hold raises ``KeyError``. Device copies of weights are
cached by namespace and version, and a version the store retires is
evicted. Every task function counts its kernel launches under its
namespace (``kernels._cuda.namespace``). A failure in the engine or a
kernel raises into the executor's retry taxonomy; nothing degrades to
another sampling path (the reference's paged -> dense fallback is not
ported).

``compile_log`` holds, per shape key, the wall time of the payload's first
call of that key on a device (an engine's construction, a new masked or
dense shape): the port's counterpart of the reference's compile walls,
which ``obs.torchwatch`` folds into the metrics registry.
"""

from __future__ import annotations

import copy
import threading
import time
import zlib
from functools import partial
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.kernels import _cuda
from repro_torch.learn.param_store import ParamStore
from repro_torch.models import protein as prot
from repro_torch.models.common import trainable
from repro_torch.runtime.allocator import (BATCH_BUCKETS, bucket_len,
                                           bucket_rows)
from repro_torch.runtime.executor import CoalesceRule

compile_log: Dict[str, list] = {}


def _pad_rows(arrs: List[np.ndarray], rows: int):
    """Pad each array's leading dim from ``rows`` up to its bucket size by
    repeating the last real row (dropped again before results return).
    Returns (padded arrays, bucket)."""
    B = bucket_rows(rows)
    if B > rows:
        arrs = [np.concatenate([a, np.repeat(a[-1:], B - rows, 0)])
                for a in arrs]
    return arrs, B


def _devices(submesh):
    """The sub-mesh's devices, each index made explicit."""
    return [resolve_device(d) for d in submesh.devices.flat]


def _split_devices(submesh, bucket: int):
    """Largest even split of ``bucket`` rows across the sub-mesh's devices.
    Returns (devices to use, rows per device)."""
    devices = _devices(submesh)
    ndev = min(len(devices), bucket)
    while bucket % ndev:
        ndev -= 1
    return devices[:ndev], bucket // ndev


def _fan_out_rows(tasks, result, n_rows):
    """Shared ``CoalesceRule.split``: slice a fused {"rows", "batch"}
    result back into one per member task, stamping fused/leader so the
    coordinator counts each dispatch's occupancy exactly once. Provenance
    (the dispatch's ``gen_version``) is copied to every member."""
    rows = result["rows"]
    info = result.get("batch", {})
    outs, at = [], 0
    for i, t in enumerate(tasks):
        k = n_rows(t)
        out = {"rows": rows[at:at + k],
               "batch": dict(info, fused=len(tasks), leader=(i == 0))}
        if "gen_version" in result:
            out["gen_version"] = result["gen_version"]
        outs.append(out)
        at += k
    return outs


def _name_seed(name: str, seed=None) -> int:
    """A namespace's weight seed: ``seed``, or ``zlib.crc32(name) & 0xFFFF``
    (the same in every process, unlike the salted ``hash``)."""
    return int(seed) if seed is not None else \
        zlib.crc32(name.encode()) & 0xFFFF


def _sample_rows(params, cfg, bbs, seeds, n, length, temp, noise, row_lens,
                 dev):
    """One device's rows of a dense ``generate_batch``: host arrays in,
    (seqs (rows,n,L) i32, lls (rows,n) f32) host arrays out."""
    seqs, lps = prot.progen_sample(
        params, torch.tensor(bbs, device=dev), n, length, cfg,
        seeds=seeds, noise=noise, temperature=temp,
        return_token_lps=row_lens is not None)
    if row_lens is not None:
        valid = (torch.arange(length, device=dev)[None, None, :]
                 < torch.tensor(row_lens, device=dev)[:, None, None])
        lps = (lps * valid).sum(-1)
    return (seqs.cpu().numpy().astype(np.int32),
            lps.cpu().numpy().astype(np.float32))


def fold_in_seed(seed, i) -> int:
    """The seed of stream ``i`` of a stream seeded ``seed`` (a device's
    share of a ``generate``, a candidate of a paged row): the port's
    ``fold_in``."""
    return int(np.random.SeedSequence([int(seed), int(i)])
               .generate_state(1, np.uint64)[0])


class ProteinPayload:
    """Holds generator + scorer weights and exposes the executor's task
    functions. ``progen``/``foldscore`` take ready modules (e.g. the
    reference's weights through ``repro_torch.bridge``) in place of the
    seeded init; both are moved to ``device``. A task granted another
    device gets its own copy of the weights there, cached by namespace,
    version and device."""

    def __init__(self, seed=0, gen_cfg=None, fold_cfg=None, reduced=False,
                 length_buckets=None, device="cuda", progen=None,
                 foldscore=None):
        self.device = resolve_device(device)
        self._reduced = bool(reduced)
        get = get_reduced if reduced else get_config
        self.gen_cfg = gen_cfg or get("progen-s")
        self.fold_cfg = fold_cfg or get("foldscore-s")
        self.param_store = ParamStore(
            (progen if progen is not None else
             prot.init_progen(self.gen_cfg, seed, device="cpu")
             ).to(self.device))
        self.param_store.on_retire(
            partial(self._drop_gen_versions, "default"))
        self.fold_params = (foldscore if foldscore is not None else
                            prot.init_foldscore(self.fold_cfg, seed + 1,
                                                device="cpu")
                            ).to(self.device)
        # param-set namespaces (heterogeneous stages): task payloads pick a
        # generator/scorer by ``payload["params"]``; "default" is the
        # original single-model pair, so unstaged campaigns are untouched
        self.gen_stores: Dict[str, ParamStore] = {
            "default": self.param_store}
        self.gen_cfgs: Dict[str, object] = {"default": self.gen_cfg}
        self.fold_sets: Dict[str, Tuple] = {
            "default": (self.fold_cfg, self.fold_params)}
        # token-dim bucket edges for masked payloads; None = LENGTH_BUCKETS
        self.length_buckets = (tuple(length_buckets)
                               if length_buckets else None)
        self._cache: Dict[tuple, object] = {}
        self._cache_lock = threading.Lock()
        self._first_calls: set = set()
        self._retired_versions: set = set()

    # -- param-set namespaces ---------------------------------------------

    def add_generator(self, name: str, seed=None, cfg=None,
                      progen=None) -> ParamStore:
        """Register a second sequence-design param set under ``name``: its
        own versioned ``ParamStore`` and config (progen-s, reduced or full
        as the payload is, by default). Its weights are ``progen`` (a ready
        module), or seeded from ``seed``, by default ``zlib.crc32(name) &
        0xFFFF``. Tasks select it with ``payload["params"] == name``.
        Returns the store (the existing one if ``name`` is registered)."""
        if name in self.gen_stores:
            return self.gen_stores[name]
        cfg = cfg or (get_reduced if self._reduced else get_config)(
            "progen-s")
        if progen is None:
            # crc32, not hash(): str hashing is salted per process and would
            # make namespace inits differ across runs
            progen = prot.init_progen(cfg, _name_seed(name, seed),
                                      device="cpu")
        store = ParamStore(progen.to(self.device))
        store.on_retire(partial(self._drop_gen_versions, name))
        self.gen_stores[name] = store
        self.gen_cfgs[name] = cfg
        return store

    def add_scorer(self, name: str, seed=None, cfg=None, foldscore=None):
        """Register a second fold/score param set under ``name`` (by
        default the ``foldscore-m`` multimer scorer of a binder protocol's
        fold stage), seeded like ``add_generator`` or given as a ready
        module. Tasks select it with ``payload["params"] == name``.
        Returns its (cfg, weights)."""
        if name in self.fold_sets:
            return self.fold_sets[name]
        cfg = cfg or (get_reduced if self._reduced else get_config)(
            "foldscore-m")
        if foldscore is None:
            foldscore = prot.init_foldscore(cfg, _name_seed(name, seed),
                                            device="cpu")
        self.fold_sets[name] = (cfg, foldscore.to(self.device))
        return self.fold_sets[name]

    @property
    def gen_params(self):
        """The current generator weights (read-only view of the store)."""
        return self.param_store.current()[1]

    # -- weights per device, first calls ----------------------------------

    def _params_on(self, which, params, device):
        """``params`` on ``device``: the module itself where it lives there,
        else a copy cached by ``which`` — ``("gen", namespace, version)``
        or ``("fold", namespace)`` — and device, so a store's retired
        version is evicted per namespace. A version retired while its copy
        was being made is used uncached: the retire hook has already run
        for it, so a late insert would never be evicted."""
        if next(params.parameters()).device == device:
            return params
        key = (which, device)
        with self._cache_lock:
            p = self._cache.get(key)
        if p is None:
            p = copy.deepcopy(params).to(device)
            with self._cache_lock:
                if which not in self._retired_versions:
                    p = self._cache.setdefault(key, p)
        return p

    def _drop_gen_versions(self, namespace, versions):
        """ParamStore retire hook (bound per namespace): evict the device
        copies of the namespace's retired generator versions, and remember
        them so that a dispatch still in flight cannot re-insert one."""
        with self._cache_lock:
            self._retired_versions.update(
                ("gen", namespace, v) for v in versions)
            stale = [k for k in self._cache
                     if isinstance(k[0], tuple) and k[0][0] == "gen"
                     and k[0][1] == namespace and k[0][2] in versions]
            for k in stale:
                del self._cache[k]

    def _first(self, key, device, fn):
        """Run ``fn()``; the first call of ``key`` on ``device`` is timed to
        the end of its device work and logged in ``compile_log[key]``."""
        with self._cache_lock:
            first = (key, device) not in self._first_calls
            self._first_calls.add((key, device))
        if not first:
            return fn()
        t0 = time.monotonic()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        compile_log.setdefault(key, []).append(time.monotonic() - t0)
        return out

    def _gen_set(self, payload):
        """(namespace, store, cfg, shape-key suffix) for a sampling payload:
        ``payload["params"]`` picks the generator; KeyError if the payload
        holds no such namespace."""
        ns = payload.get("params") or "default"
        store, cfg = self.gen_stores[ns], self.gen_cfgs[ns]
        return ns, store, cfg, ("" if ns == "default" else f"@{ns}")

    def _fold_set(self, payload):
        """(namespace, cfg, weights, shape-key suffix) for a scoring
        payload: ``payload["params"]`` picks the scorer; KeyError if the
        payload holds no such namespace."""
        ns = payload.get("params") or "default"
        cfg, params = self.fold_sets[ns]
        return ns, cfg, params, ("" if ns == "default" else f"@{ns}")

    # -- task functions ---------------------------------------------------

    def generate(self, submesh, payload):
        """Sample payload['n'] candidate sequences of one backbone, split
        across the sub-mesh's devices, device ``i`` drawing from seed
        ``fold_in_seed(payload['seed'], i)``. Optional ``noise`` (n, length,
        padded_vocab) replaces the seeded Gumbel draws, row j for candidate
        j. Returns {"seqs" (n,L) np.int32, "lls" (n,) np.float32,
        "gen_version" int}."""
        ns, store, cfg, sfx = self._gen_set(payload)
        with torch.inference_mode(), _cuda.namespace(ns):
            n, length = int(payload["n"]), int(payload["length"])
            temp = float(payload.get("temperature", 1.0))
            devices = _devices(submesh)
            per = -(-n // len(devices))
            backbone = np.asarray(payload["backbone"],
                                  np.float32)[None, :cfg.frontend_seq]
            noise = payload.get("noise")
            if noise is not None:
                noise = np.asarray(noise, np.float32)
            ver, gparams = store.current()
            outs = []
            for i, dev in enumerate(devices):
                take = min(per, n - i * per)
                if take <= 0:
                    break
                gp = self._params_on(("gen", ns, ver), gparams, dev)
                bb = torch.tensor(backbone, device=dev)
                nz = None if noise is None else noise[i * per:i * per + take]
                outs.append(self._first(
                    f"generate{take}_L{length}_t{temp}{sfx}", dev,
                    lambda: prot.progen_sample(
                        gp, bb, take, length, cfg,
                        seeds=[fold_in_seed(payload["seed"], i)], noise=nz,
                        temperature=temp)))
            seqs = np.concatenate([s[0][0].cpu().numpy() for s in outs])
            lls = np.concatenate([s[1][0].cpu().numpy() for s in outs])
            return {"seqs": seqs.astype(np.int32),
                    "lls": lls.astype(np.float32), "gen_version": ver}

    def predict(self, submesh, payload):
        """Score one sequence. Returns {"plddt","ptm","pae"} floats.

        With ``seq_len`` in the payload (the row's true length, set by the
        protocol when length bucketing is active) the sequence is padded to
        its length bucket and scored by the masked scorer; without it, at
        its exact length with ``chain_split = receptor_len``."""
        ns, fcfg, fparams, sfx = self._fold_set(payload)
        with torch.inference_mode(), _cuda.namespace(ns):
            dev = _devices(submesh)[0]
            fp = self._params_on(("fold", ns), fparams, dev)
            seq = np.asarray(payload["sequence"], np.int32)[None]
            tgt = torch.tensor(np.asarray(payload["target"],
                                          np.float32)[None], device=dev)
            split = int(payload["receptor_len"])
            if payload.get("seq_len") is not None:
                Lb = bucket_len(seq.shape[1], self.length_buckets)
                seq = np.pad(seq, ((0, 0), (0, Lb - seq.shape[1])))
                put = lambda a: torch.tensor(np.asarray([a], np.int32),
                                             device=dev)
                m = self._first(
                    f"predict_mb1_L{Lb}{sfx}", dev,
                    lambda: prot.foldscore_fwd_masked(
                        fp, torch.tensor(seq, device=dev), tgt,
                        put(payload["seq_len"]), put(split), fcfg))
            else:
                m = self._first(
                    f"predict{seq.shape[1]}_{split}{sfx}", dev,
                    lambda: prot.foldscore_fwd(
                        fp, torch.tensor(seq, device=dev), tgt, fcfg,
                        chain_split=split))
            return prot.metrics_rows(m)[0]

    def predict_batch(self, submesh, payload):
        """Score a stack of sequences in one call per device.

        payload: sequences (R, L) int; target (16,) shared or (R, 16)
        per-row; receptor_len int. Masked mixed-length form: with per-row
        ``seq_lens`` (and optional per-row ``chain_splits``, defaulting to
        ``receptor_len``) the token dim is padded to a length bucket and
        scored by ``foldscore_fwd_masked``.

        Returns {"rows": [per-row metric dicts], "batch": occupancy info
        incl. ``len_occupancy`` = real tokens / padded tokens}."""
        ns, fcfg, fparams, sfx = self._fold_set(payload)
        with torch.inference_mode(), _cuda.namespace(ns):
            seqs = np.asarray(payload["sequences"], np.int32)
            if seqs.ndim == 1:
                seqs = seqs[None]
            R, L = seqs.shape
            tgt = np.asarray(payload["target"], np.float32)
            if tgt.ndim == 1:
                tgt = np.tile(tgt[None], (R, 1))
            seq_lens = payload.get("seq_lens")
            masked = seq_lens is not None
            if masked:
                seq_lens = np.asarray(seq_lens, np.int32).reshape(-1)
                splits = np.asarray(
                    payload.get("chain_splits",
                                np.full(R, int(payload["receptor_len"]))),
                    np.int32).reshape(-1)
                Lb = bucket_len(L, self.length_buckets)
                seqs = np.pad(seqs, ((0, 0), (0, Lb - L)))
                L = Lb
                len_occ = float(seq_lens.sum()) / float(R * L)
                (seqs, tgt, seq_lens, splits), B = _pad_rows(
                    [seqs, tgt, seq_lens, splits], R)
            else:
                split = int(payload["receptor_len"])
                len_occ = 1.0
                (seqs, tgt), B = _pad_rows([seqs, tgt], R)
            devices, per = _split_devices(submesh, B)
            outs = []
            for i, dev in enumerate(devices):
                sl = slice(i * per, (i + 1) * per)
                fp = self._params_on(("fold", ns), fparams, dev)
                put = lambda a: torch.tensor(a[sl], device=dev)
                if masked:
                    outs.append(self._first(
                        f"predict_mb{per}_L{L}{sfx}", dev,
                        lambda: prot.foldscore_fwd_masked(
                            fp, put(seqs), put(tgt), put(seq_lens),
                            put(splits), fcfg)))
                else:
                    outs.append(self._first(
                        f"predict_b{per}_L{L}_{split}{sfx}", dev,
                        lambda: prot.foldscore_fwd(
                            fp, put(seqs), put(tgt), fcfg,
                            chain_split=split)))
            rows = [r for m in outs for r in prot.metrics_rows(m)][:R]
            batch = {"rows": R, "bucket": B, "occupancy": R / B,
                     "devices": len(devices), "len_occupancy": len_occ}
            return {"rows": rows, "batch": batch}

    def generate_batch(self, submesh, payload):
        """Sample a (rows, n, L) candidate stack, one row per pipeline.

        payload: backbones (R, P, 16) f32 (or (P, 16) for one row); seeds
        (R,) per-row seeds; n, length, temperature as in ``generate``;
        optional ``noise`` (R, n, length, padded_vocab) Gumbel draws
        replacing the seeded ones. The row dim is padded to a
        ``BATCH_BUCKETS`` size and split evenly across the sub-mesh's
        devices; each device samples its rows in one ``progen_sample`` call,
        each row from a generator seeded with the row's seed.

        Masked form: with per-row ``row_lens``, ``length`` is the shared
        bucketed sample length; every row samples at the bucket, its
        log-likelihood is masked to its true length on the device and its
        tokens are truncated on the host.

        Paged form (``decode="paged"``): ``_generate_batch_paged``.

        Returns {"rows": [(seqs (n,L) i32, lls (n,) f32) per row],
        "batch": occupancy info (incl. ``len_occupancy``), "gen_version":
        the generator version the dispatch sampled from}."""
        ns, store, cfg, sfx = self._gen_set(payload)
        with torch.inference_mode(), _cuda.namespace(ns):
            if payload.get("decode") == "paged":
                return self._generate_batch_paged(submesh, payload, ns, store,
                                                  cfg, sfx)
            bbs = np.asarray(payload["backbones"], np.float32)
            if bbs.ndim == 2:
                bbs = bbs[None]
            bbs = bbs[:, :cfg.frontend_seq]
            R = bbs.shape[0]
            n, length = int(payload["n"]), int(payload["length"])
            temp = float(payload.get("temperature", 1.0))
            seeds = np.asarray(payload["seeds"], np.int64).reshape(-1)
            noise = payload.get("noise")
            arrs = [bbs, seeds] + ([] if noise is None else
                                   [np.asarray(noise, np.float32)])
            row_lens = payload.get("row_lens")
            masked = row_lens is not None
            if masked:
                row_lens = np.asarray(row_lens, np.int32).reshape(-1)
                len_occ = float(row_lens.sum()) / float(R * length)
                arrs.append(row_lens)
            else:
                len_occ = 1.0
            arrs, B = _pad_rows(arrs, R)
            bbs, seeds = arrs[:2]
            noise = None if noise is None else arrs[2]
            lens = arrs[-1] if masked else None
            ver, gparams = store.current()
            devices, per = _split_devices(submesh, B)
            kind = "generate_mb" if masked else "generate_b"
            outs = []
            for i, dev in enumerate(devices):
                sl = slice(i * per, (i + 1) * per)
                gp = self._params_on(("gen", ns, ver), gparams, dev)
                outs.append(self._first(
                    f"{kind}{per}_n{n}_L{length}_t{temp}{sfx}", dev,
                    lambda: _sample_rows(
                        gp, cfg, bbs[sl], seeds[sl], n, length, temp,
                        None if noise is None else noise[sl],
                        None if lens is None else lens[sl], dev)))
            seqs = np.concatenate([s for s, _ in outs])[:R]
            lls = np.concatenate([ll for _, ll in outs])[:R]
            rows = [(seqs[r][:, :row_lens[r]] if masked else seqs[r],
                     lls[r]) for r in range(R)]
            batch = {"rows": R, "bucket": B, "occupancy": R / B,
                     "devices": len(devices), "len_occupancy": len_occ}
            return {"rows": rows, "batch": batch, "gen_version": ver}

    def backbone_batch(self, submesh, payload):
        """Backbone-sampling stage: perturb each row's base backbone into
        ``m`` candidates and score their pooled-embedding fit against the
        row's target. It runs no model, so it reads no param-set namespace
        (as in the reference).

        payload: bases (R, P, 16) f32 (or (P, 16) for one row); targets
        (R, 16) f32 (or (16,) shared); seeds (R,) per-row seeds; m int;
        sigma float perturbation scale; optional ``noise`` (R, m, P, 16)
        standard normal draws replacing the seeded ones (row r's from a
        generator seeded ``seeds[r]``). Rows pad to a ``BATCH_BUCKETS``
        size and split across the sub-mesh like the other batched kinds.

        Returns {"rows": [(cands (m,P,16) f32, scores (m,) f32) per row],
        "batch": occupancy info}."""
        with torch.inference_mode():
            bases = np.asarray(payload["bases"], np.float32)
            if bases.ndim == 2:
                bases = bases[None]
            R, P = bases.shape[:2]
            tgts = np.asarray(payload["targets"], np.float32)
            if tgts.ndim == 1:
                tgts = np.tile(tgts[None], (R, 1))
            seeds = np.asarray(payload["seeds"], np.int64).reshape(-1)
            m = int(payload["m"])
            sigma = float(payload.get("sigma", 0.1))
            noise = payload.get("noise")
            arrs = [bases, tgts, seeds] + ([] if noise is None else
                                           [np.asarray(noise, np.float32)])
            arrs, B = _pad_rows(arrs, R)
            devices, per = _split_devices(submesh, B)
            outs = []
            for i, dev in enumerate(devices):
                sl = slice(i * per, (i + 1) * per)
                if noise is None:
                    nz = torch.stack([torch.randn(
                        (m, P, 16), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            int(s))) for s in arrs[2][sl]])
                else:
                    nz = torch.tensor(arrs[3][sl], device=dev)
                base = torch.tensor(arrs[0][sl], device=dev)
                tgt = torch.tensor(arrs[1][sl], device=dev)
                cands = base[:, None] + sigma * nz     # (rows, m, P, 16)
                emb = cands.mean(2)                    # pooled (rows, m, 16)
                scores = -((emb - tgt[:, None]) ** 2).mean(-1)
                outs.append((cands.cpu().numpy(), scores.cpu().numpy()))
            cands = np.concatenate([c for c, _ in outs])[:R]
            scores = np.concatenate([s for _, s in outs])[:R]
            rows = [(cands[r].astype(np.float32),
                     scores[r].astype(np.float32)) for r in range(R)]
            batch = {"rows": R, "bucket": B, "occupancy": R / B,
                     "devices": len(devices)}
            return {"rows": rows, "batch": batch}

    def _paged_parse(self, payload, length, gcfg):
        """Normalize a paged generate payload's per-row arrays, its
        backbones cut to the frontend of its namespace's generator ``gcfg``."""
        bbs = np.asarray(payload["backbones"], np.float32)
        if bbs.ndim == 2:
            bbs = bbs[None]
        bbs = bbs[:, :gcfg.frontend_seq]
        seeds = np.asarray(payload["seeds"], np.int64).reshape(-1)
        rl = payload.get("row_lens")
        rl = (np.asarray(rl, np.int32).reshape(-1) if rl is not None
              else np.full(bbs.shape[0], length, np.int32))
        noise = payload.get("noise")
        if noise is not None:
            noise = np.asarray(noise, np.float32)
        return bbs, seeds, rl, noise

    def _engine(self, slots, length, page_size, dev, cfg, sfx=""):
        """The engine of (slots, length, page size) for the generator config
        ``cfg`` (namespace suffix ``sfx``) on ``dev``, built on first use
        (its construction is that key's first call)."""
        key = f"paged{slots}_L{length}_p{page_size}{sfx}"
        with self._cache_lock:
            eng = self._cache.get((key, dev))
        if eng is None:
            eng = self._first(key, dev, lambda: prot.PagedDecodeEngine(
                cfg, slots=slots, max_new=length, page_size=page_size,
                device=dev))
            with self._cache_lock:
                eng = self._cache.setdefault((key, dev), eng)
        return eng

    def _generate_batch_paged(self, submesh, payload, ns, store, gcfg, sfx):
        """Continuous batching over a paged KV cache on the sub-mesh's first
        device, on the generator ``generate_batch`` resolved for the payload
        (namespace ``ns``, its store, cfg and shape-key suffix). One engine
        per (slots, length, page size, namespace) serves every dispatch.
        Live admission: with an admission port in ``payload["_admit"]`` the
        engine's poll hook pulls compatible queued tasks into the running
        decode whenever slots free up; their rows follow the initial rows in
        the result. Optional ``noise`` (R, n, length, padded_vocab) replaces
        the seeded draws."""
        dev = _devices(submesh)[0]
        n = int(payload["n"])
        length = int(payload["length"])
        temp = float(payload.get("temperature", 1.0))
        page_size = int(payload.get("page_size", 8))
        port = payload.get("_admit")
        bbs, seeds, row_lens, noise = self._paged_parse(payload, length, gcfg)
        R0 = bbs.shape[0]
        slots = int(payload.get("decode_slots", 0)) \
            or min(max(R0 * n, 4), 32)
        eng = self._engine(slots, length, page_size, dev, gcfg, sfx)
        ver, gparams = store.current()
        gp = self._params_on(("gen", ns, ver), gparams, dev)

        records = []           # (tag0, n_rows) in result-row order

        def specs_for(bb, sds, rl, nz, tag0):
            out = []
            for r in range(bb.shape[0]):
                out += [dict(backbone=bb[r], seed=fold_in_seed(sds[r], c),
                             length=int(rl[r]), tag=(tag0, r, c),
                             noise=None if nz is None else nz[r, c])
                        for c in range(n)]
            records.append((tag0, bb.shape[0]))
            return out

        admitted = []
        occ_rows = [(int(row_lens.sum()), R0)]

        def poll(free):
            if port is None or free < n:
                return []
            out = []
            for t in port.take(free // n):
                admitted.append(t)
                abb, asd, arl, anz = self._paged_parse(t.payload, length,
                                                       gcfg)
                out += specs_for(abb, asd, arl, anz, len(admitted))
                occ_rows.append((int(arl.sum()), abb.shape[0]))
            return out

        with eng.lock:
            steps0, admits0 = eng.n_steps, eng.n_admits
            res = eng.run(gp, temp,
                          specs=specs_for(bbs, seeds, row_lens, noise, 0),
                          poll=poll)
            steps, admits = eng.n_steps - steps0, eng.n_admits - admits0
        rows = []
        for tag0, nr in sorted(records):
            for r in range(nr):
                picks = [res[(tag0, r, c)] for c in range(n)]
                rows.append((np.stack([p[0] for p in picks]).astype(np.int32),
                             np.asarray([p[1] for p in picks], np.float32)))
        R = sum(nr for _, nr in records)
        tok_sum = sum(s for s, _ in occ_rows)
        batch = {"rows": R, "bucket": slots,
                 "occupancy": min(1.0, (R * n) / slots), "devices": 1,
                 "len_occupancy": tok_sum / float(R * length),
                 "decode": "paged", "admitted": len(admitted),
                 "steps": steps, "admits": admits}
        return {"rows": rows, "batch": batch, "gen_version": ver}

    # -- registration -----------------------------------------------------

    def register_all(self, executor, generate_batch_rows: int = None,
                     coalesce: bool = True, length_buckets=None,
                     decode_kernel: bool = False):
        """Register every task fn (and, when the executor supports it, the
        batched kinds' coalesce rules). ``generate_batch_rows`` bounds the
        fused generate batch (pass ``ProtocolConfig.generate_batch_size``);
        None keeps the BATCH_BUCKETS cap. ``coalesce=False`` skips the
        coalesce rules. ``length_buckets`` installs campaign-derived
        token-dim bucket edges; None keeps the payload's current table.
        ``decode_kernel=True`` marks the generate_batch rule ``live`` so
        paged dispatches can admit queued tasks mid-decode."""
        if length_buckets is not None:
            self.length_buckets = tuple(length_buckets)
        executor.register("generate", self.generate)
        executor.register("generate_batch", self.generate_batch)
        executor.register("predict", self.predict)
        executor.register("predict_batch", self.predict_batch)
        executor.register("backbone_batch", self.backbone_batch)
        if coalesce and hasattr(executor, "register_coalescable"):
            executor.register_coalescable(
                "predict_batch",
                predict_batch_coalesce_rule(
                    length_buckets=self.length_buckets))
            executor.register_coalescable(
                "generate_batch",
                generate_batch_coalesce_rule(
                    max_rows=(generate_batch_rows if generate_batch_rows
                              else BATCH_BUCKETS[-1]),
                    prefix_len=self.gen_cfg.frontend_seq,
                    live=decode_kernel))
            executor.register_coalescable(
                "backbone_batch", backbone_batch_coalesce_rule())

    def coalesce_rule_for(self, kind: str, *, max_rows: int = None,
                          admission_window: float = None):
        """Build the coalesce rule for one of this payload's batched task
        kinds with per-stage overrides."""
        kw = {}
        if max_rows is not None:
            kw["max_rows"] = int(max_rows)
        if kind == "predict_batch":
            return predict_batch_coalesce_rule(
                length_buckets=self.length_buckets, **kw)
        if kind == "generate_batch":
            if admission_window is not None:
                kw["admission_window"] = float(admission_window)
            return generate_batch_coalesce_rule(
                prefix_len=self.gen_cfg.frontend_seq, **kw)
        if kind == "backbone_batch":
            if admission_window is not None:
                kw["admission_window"] = float(admission_window)
            return backbone_batch_coalesce_rule(**kw)
        raise KeyError(f"no coalesce rule for task kind {kind!r}")

    def register_stages(self, executor, stages, coalesce: bool = True):
        """Wire a stage table (``core.stages.StageSpec`` sequence) into the
        executor: create each stage's param-set namespace (generator for
        sampling kinds, scorer for fold kinds) and register its
        stage-specific coalesce rule (keyed ``(kind, stage)``: the executor
        already keeps cross-stage tasks apart). Call after
        ``register_all``; safe to call once per protocol sharing stages.
        ``coalesce=False`` creates the namespaces but skips the rules, so
        an unfused baseline campaign still resolves its param sets."""
        for s in stages:
            if s.params != "default":
                if s.kind in ("generate", "generate_batch"):
                    self.add_generator(s.params)
                elif s.kind in ("predict", "predict_batch"):
                    self.add_scorer(s.params)
            if s.kind in ("predict", "generate"):  # solo kinds never fuse
                continue
            if coalesce and hasattr(executor, "register_coalescable"):
                executor.register_coalescable(
                    s.kind,
                    self.coalesce_rule_for(
                        s.kind, max_rows=s.max_rows,
                        admission_window=s.admission_window),
                    stage=s.name)


def predict_batch_coalesce_rule(max_rows: int = BATCH_BUCKETS[-1],
                                length_buckets=None):
    """Coalescing contract for ``predict_batch`` tasks (a copy of the
    reference's). Payloads without ``seq_lens`` fuse on the exact
    (sequence length, chain split); masked payloads fuse on the length
    bucket alone, tasks of different lengths and receptor splits merging
    into one padded batch with per-row ``seq_lens``/``chain_splits``. The
    two families never fuse with each other."""

    def n_rows(task):
        s = np.asarray(task.payload["sequences"])
        return 1 if s.ndim == 1 else int(s.shape[0])

    def width(task):
        return int(np.asarray(task.payload["sequences"]).shape[-1])

    def key(task):
        ns = task.payload.get("params")  # param-set namespace: tasks
        # scoring with different fold param sets must never share a batch
        if "seq_lens" in task.payload:
            return ("masked", bucket_len(width(task), length_buckets), ns)
        return (width(task), int(task.payload["receptor_len"]), ns)

    def merge(tasks):
        masked = "seq_lens" in tasks[0].payload
        Lb = (bucket_len(max(width(t) for t in tasks), length_buckets)
              if masked else None)
        seq_stacks, tgt_stacks, lens, splits = [], [], [], []
        for t in tasks:
            s = np.asarray(t.payload["sequences"], np.int32)
            if s.ndim == 1:
                s = s[None]
            g = np.asarray(t.payload["target"], np.float32)
            if g.ndim == 1:
                g = np.tile(g[None], (s.shape[0], 1))
            if masked:
                if Lb > s.shape[1]:   # pad member stacks to the bucket
                    s = np.concatenate(
                        [s, np.zeros((s.shape[0], Lb - s.shape[1]),
                                     np.int32)], axis=1)
                lens.append(np.asarray(t.payload["seq_lens"],
                                       np.int32).reshape(-1))
                splits.append(np.asarray(
                    t.payload.get("chain_splits",
                                  np.full(s.shape[0],
                                          int(t.payload["receptor_len"]))),
                    np.int32).reshape(-1))
            seq_stacks.append(s)
            tgt_stacks.append(g)
        fused = {"sequences": np.concatenate(seq_stacks),
                 "target": np.concatenate(tgt_stacks),
                 "receptor_len": tasks[0].payload["receptor_len"]}
        if masked:
            fused["seq_lens"] = np.concatenate(lens)
            fused["chain_splits"] = np.concatenate(splits)
        if tasks[0].payload.get("params"):
            fused["params"] = tasks[0].payload["params"]
        return fused

    def split(tasks, result):
        return _fan_out_rows(tasks, result, n_rows)

    return CoalesceRule(key=key, merge=merge, split=split, rows=n_rows,
                        max_rows=max_rows)


def generate_batch_coalesce_rule(max_rows: int = BATCH_BUCKETS[-1],
                                 admission_window: float = 0.005,
                                 prefix_len: int = None,
                                 live: bool = False):
    """Coalescing contract for ``generate_batch`` tasks (a copy of the
    reference's): one-row tasks from different pipelines with the same (n,
    length, backbone prefix shape, temperature) stack into one device
    batch; per-row seeds keep each pipeline's sampling stream. Masked and
    paged payloads compare and merge backbones on their ``prefix_len``
    prefix; masked, paged and plain tasks never fuse with each other.
    ``live=True`` lets the paged payload pull compatible queued tasks into
    a running decode through the executor's ``AdmissionPort``. Injected
    ``noise`` is test input and does not fuse."""

    def bbs(task):
        b = np.asarray(task.payload["backbones"], np.float32)
        return b[None] if b.ndim == 2 else b

    def n_rows(task):
        return int(bbs(task).shape[0])

    def key(task):
        p = task.payload
        shape = bbs(task).shape[1:]
        decode = p.get("decode")
        ns = p.get("params")   # param-set namespace never fuses across
        if "row_lens" in p or decode == "paged":
            if prefix_len:
                shape = (min(shape[0], prefix_len),) + shape[1:]
            return ("masked", decode, int(p["n"]), int(p["length"]), shape,
                    float(p.get("temperature", 1.0)), ns)
        return (int(p["n"]), int(p["length"]), shape,
                float(p.get("temperature", 1.0)), ns)

    def merge(tasks):
        p0 = tasks[0].payload
        masked = "row_lens" in p0 or p0.get("decode") == "paged"
        stacks = [bbs(t) for t in tasks]
        if masked and prefix_len:
            stacks = [b[:, :prefix_len] for b in stacks]
        fused = {"backbones": np.concatenate(stacks),
                 "seeds": np.concatenate(
                     [np.asarray(t.payload["seeds"], np.int64).reshape(-1)
                      for t in tasks]),
                 "n": p0["n"],
                 "length": p0["length"],
                 "temperature": p0.get("temperature", 1.0)}
        if masked:
            fused["row_lens"] = np.concatenate(
                [np.asarray(t.payload.get(
                     "row_lens", np.full(bbs(t).shape[0], int(p0["length"]),
                                         np.int32)), np.int32).reshape(-1)
                 for t in tasks])
        for k in ("decode", "decode_slots", "page_size", "params"):
            if k in p0:
                fused[k] = p0[k]
        return fused

    def split(tasks, result):
        return _fan_out_rows(tasks, result, n_rows)

    return CoalesceRule(key=key, merge=merge, split=split, rows=n_rows,
                        max_rows=max_rows,
                        admission_window=admission_window, live=live)


def backbone_batch_coalesce_rule(max_rows: int = BATCH_BUCKETS[-1],
                                 admission_window: float = 0.005):
    """Coalescing contract for ``backbone_batch`` tasks (a copy of the
    reference's): one-row tasks from different pipelines with the same (m,
    base shape, sigma) stack into one device batch; per-row seeds keep each
    pipeline's candidate stream."""

    def bases(task):
        b = np.asarray(task.payload["bases"], np.float32)
        return b[None] if b.ndim == 2 else b

    def n_rows(task):
        return int(bases(task).shape[0])

    def key(task):
        p = task.payload
        return (int(p["m"]), bases(task).shape[1:],
                float(p.get("sigma", 0.1)), p.get("params"))

    def merge(tasks):
        p0 = tasks[0].payload

        def tgts(t):
            g = np.asarray(t.payload["targets"], np.float32)
            return np.tile(g[None], (bases(t).shape[0], 1)) \
                if g.ndim == 1 else g

        fused = {"bases": np.concatenate([bases(t) for t in tasks]),
                 "targets": np.concatenate([tgts(t) for t in tasks]),
                 "seeds": np.concatenate(
                     [np.asarray(t.payload["seeds"], np.int64).reshape(-1)
                      for t in tasks]),
                 "m": p0["m"], "sigma": p0.get("sigma", 0.1)}
        if p0.get("params"):
            fused["params"] = p0["params"]
        return fused

    def split(tasks, result):
        return _fan_out_rows(tasks, result, n_rows)

    return CoalesceRule(key=key, merge=merge, split=split, rows=n_rows,
                        max_rows=max_rows,
                        admission_window=admission_window)


class FinetunePayload:
    """The ``finetune`` task kind — the §V model-evolution trainer payload:
    accepted designs (HPC output) become training data that evolves the
    generative model, with a fitness-weighted NLL objective (the simplest
    form of the paper's MProt-DPO-flavoured 'evolve the generator'). A port
    of the JAX package's ``FinetunePayload``.

    Built on ``optim.train_step.make_train_step``: AdamW steps on a
    trainable fp32 copy of the generator's current weights, made from the
    store's own module (never from a payload's per-device copy: those are
    made under inference mode). Its attention forward is the flash kernel
    (bf16 compute: its ``mma.sync`` sequence form, one launch a layer a
    step), its backward the kernel's plain gradient. On a sub-mesh of
    several devices the design batch is split across them (rows padded to
    a multiple of the device count with weight 0), each device runs a
    replica, each shard's loss is normalized by the whole batch's weight
    sum, and the gradients are summed on the first device before the
    single update. Evolved weights are published to the generator's
    ``ParamStore`` as a new version, a module on the payload's device with
    ``requires_grad=False`` — generators hot-swap on their next dispatch,
    in-flight dispatches finish on the version they started with.

    Preemption contract: for preemptible tasks the executor injects the
    live task as ``payload["_task"]``; between train steps the loop checks
    ``preempt_requested`` (and ``canceled``) and yields early, returning
    host-side resume state (weights and moments as CPU tensors, step,
    losses) in the result. The trainer service resubmits the continuation
    (``payload["resume"]``) on the next idle window, so a queued design
    task waits at most one train step and no training progress is lost.

    The task function does not enter inference mode; it counts its
    launches under its generator's namespace (``_cuda.namespace``)."""

    def __init__(self, protein_payload, lr=1e-4, steps=20, param_store=None):
        from repro_torch.optim import OptConfig
        self.pp = protein_payload
        self.store = param_store or protein_payload.param_store
        self.namespace = next((ns for ns, st in self.pp.gen_stores.items()
                               if st is self.store), "default")
        self.cfg = self.pp.gen_cfgs.get(self.namespace, self.pp.gen_cfg)
        self.opt = OptConfig(lr=lr, warmup_steps=2, total_steps=steps,
                             weight_decay=0.0)
        self.steps = steps
        self._step_fn = None

    def loss_fn(self, params, batch):
        """The fitness-normalized weighted NLL and the mean log-likelihood
        of the real rows (weight > 0); ``seq_lens``, when given, masks a
        mixed-length batch. A shard of a split batch carries the whole
        batch's weight sum and real-row count as per-row columns
        (``w_total``, ``real_total``)."""
        lp = prot.progen_logprobs(params, batch["backbones"],
                                  batch["sequences"], self.cfg,
                                  seq_lens=batch.get("seq_lens"))
        w = batch["weights"]
        real = (w > 0).float()                       # pad rows weigh 0
        w_sum = batch["w_total"][0] if "w_total" in batch else w.sum()
        n_real = batch["real_total"][0] if "real_total" in batch \
            else real.sum()
        loss = -(w / torch.clamp(w_sum, min=1e-6) * lp).sum()
        mean_ll = (real * lp).sum() / torch.clamp(n_real, min=1.0)
        return loss, {"loss": loss, "mean_ll": mean_ll}

    def _train_step(self):
        if self._step_fn is None:
            from repro_torch.optim import make_train_step
            self._step_fn = make_train_step(self.cfg, self.opt,
                                            loss_fn=self.loss_fn)
        return self._step_fn

    def finetune(self, submesh, payload):
        """payload: backbones (B,P,16) f32; sequences (B,L) i32; weights
        (B,) f32 (fitness-derived, >= 0); seq_lens (optional (B,)); steps
        (optional int); resume (optional, from a preempted run's result);
        _task (injected by the executor for preemptible tasks).

        Returns metrics incl. base/new generator version, or — when
        preempted — partial metrics plus ``resume`` state."""
        from repro_torch.optim import init_opt_state
        t_start = time.monotonic()
        task = payload.get("_task")
        cfg = self.cfg
        devices = _devices(submesh)
        ndev = len(devices)
        seqs = np.asarray(payload["sequences"], np.int32)
        bbs = np.asarray(payload["backbones"],
                         np.float32)[:, :cfg.frontend_seq]
        w = np.maximum(np.asarray(payload["weights"], np.float32), 0.0)
        cols = {"backbones": bbs, "sequences": seqs, "weights": w}
        if payload.get("seq_lens") is not None:
            cols["seq_lens"] = np.asarray(payload["seq_lens"],
                                          np.int32).reshape(-1)
        n_real = int(seqs.shape[0])
        pad = (-n_real) % ndev    # the split needs B % ndev == 0
        if pad:
            cols = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                    for k, v in cols.items()}
            cols["weights"][n_real:] = 0.0
        total = int(payload.get("steps", self.steps))
        resume = payload.get("resume")
        with torch.enable_grad(), _cuda.namespace(self.namespace):
            if resume is not None:
                base_version = int(resume["base_version"])
                params = trainable(self.store.current()[1], devices[0])
                with torch.no_grad():
                    for n, p in params.named_parameters():
                        p.copy_(resume["params"][n])
                st = resume["opt_state"]
                opt_state = {   # copies: the step updates them in place
                    k: {n: t.to(devices[0], copy=True)
                        for n, t in st[k].items()}
                    for k in ("m", "v")}
                opt_state["count"] = int(st["count"])
                start = int(resume["step"])
                losses = list(resume["losses"])
                mean_lls = list(resume["mean_lls"])
            else:
                base_version, master = self.store.current()
                params = trainable(master, devices[0])
                opt_state = init_opt_state(dict(params.named_parameters()),
                                           self.opt)
                start, losses, mean_lls = 0, [], []
            replicas = batch = None
            if ndev == 1:
                batch = {k: torch.tensor(v, device=devices[0])
                         for k, v in cols.items()}
            else:
                replicas = [params] + [trainable(params, d)
                                       for d in devices[1:]]
                per = len(cols["sequences"]) // ndev
                totals = {"w_total": float(cols["weights"].sum()),
                          "real_total": float((cols["weights"] > 0).sum())}
                batch = [dict({k: torch.tensor(v[i * per:(i + 1) * per],
                                               device=d)
                               for k, v in cols.items()},
                              **{k: torch.full((per,), t, device=d)
                                 for k, t in totals.items()})
                         for i, d in enumerate(devices)]
            step = self._train_step()
            preempted = False
            k = start
            while k < total:
                params, opt_state, metrics = step(params, opt_state, batch,
                                                  replicas)
                losses.append(float(metrics["loss"]))
                mean_lls.append(float(metrics["mean_ll"]))
                k += 1
                if task is not None and k < total \
                        and (task.preempt_requested or task.canceled):
                    preempted = True   # yield the sub-mesh to design work
                    break
            info = {"steps_done": k, "steps_run": k - start,
                    "n_designs": n_real, "n_devices": ndev,
                    "base_version": base_version,
                    "elapsed_s": time.monotonic() - t_start}
            if preempted:
                host = lambda d: {n: t.detach().to("cpu", copy=True)
                                  for n, t in d.items()}
                return dict(info, preempted=True, resume={
                    "params": host(dict(params.named_parameters())),
                    "opt_state": {"m": host(opt_state["m"]),
                                  "v": host(opt_state["v"]),
                                  "count": opt_state["count"]},
                    "step": k, "base_version": base_version,
                    "losses": losses, "mean_lls": mean_lls})
            # publish the evolved generator as a new version; generators
            # hot-swap on their next dispatch
            evolved = copy.deepcopy(params).requires_grad_(False).to(
                self.pp.device)
        new_version = self.store.publish(evolved)
        return dict(info, preempted=False, new_version=new_version,
                    loss_first=losses[0], loss_last=losses[-1],
                    mean_ll_first=mean_lls[0], mean_ll_last=mean_lls[-1])

    def register(self, executor):
        executor.register("finetune", self.finetune)
