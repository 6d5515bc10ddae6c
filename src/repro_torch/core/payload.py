"""Device payload functions for IMPRESS tasks (port of the reference's
``core/payload.py``, the paged and masked path).

``generate_batch`` (ProteinMPNN analogue), paged form: every (row,
  candidate) pair becomes one decode slot of a ``PagedDecodeEngine`` —
  token-by-token continuous batching over a paged KV cache. Candidate ``c``
  of a row seeded ``s`` samples from its own generator, seeded from
  ``(s, c)``, so a row's tokens do not depend on which rows share the
  engine.
``predict_batch`` (AlphaFold analogue): scores a stack of sequences in one
  call; with per-row ``seq_lens`` the masked form pads the token dim to a
  length bucket and excludes pad positions from every metric.

Both pad their batch dim to a ``BATCH_BUCKETS`` size (pad rows repeat the
last real row and are dropped before returning). A failure in the engine or
a kernel raises; nothing degrades to another sampling path.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import protein as prot
from repro_torch.runtime.allocator import bucket_len, bucket_rows


def _pad_rows(arrs: List[np.ndarray], rows: int):
    """Pad each array's leading dim from ``rows`` up to its bucket size by
    repeating the last real row (dropped again before results return).
    Returns (padded arrays, bucket)."""
    B = bucket_rows(rows)
    if B > rows:
        arrs = [np.concatenate([a, np.repeat(a[-1:], B - rows, 0)])
                for a in arrs]
    return arrs, B


def candidate_seed(seed, candidate) -> int:
    """Generator seed of candidate ``candidate`` of a row seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(candidate)])
               .generate_state(1, np.uint64)[0])


class ProteinPayload:
    """Holds generator + scorer weights on one device and exposes the
    executor's task functions. ``progen``/``foldscore`` take ready modules
    (e.g. the reference's weights through ``repro_torch.bridge``) in place
    of the seeded init."""

    def __init__(self, seed=0, gen_cfg=None, fold_cfg=None, reduced=False,
                 length_buckets=None, device="cuda", progen=None,
                 foldscore=None):
        self.device = resolve_device(device)
        get = get_reduced if reduced else get_config
        self.gen_cfg = gen_cfg or get("progen-s")
        self.fold_cfg = fold_cfg or get("foldscore-s")
        self.gen_params = (progen if progen is not None else
                           prot.init_progen(self.gen_cfg, seed, device="cpu")
                           ).to(self.device)
        self.fold_params = (foldscore if foldscore is not None else
                            prot.init_foldscore(self.fold_cfg, seed + 1,
                                                device="cpu")
                            ).to(self.device)
        # token-dim bucket edges for masked payloads; None = LENGTH_BUCKETS
        self.length_buckets = (tuple(length_buckets)
                               if length_buckets else None)
        self._engines = {}
        self._engines_lock = threading.Lock()

    def _task_device(self, submesh) -> torch.device:
        dev = resolve_device(submesh.devices[0])
        if dev != self.device:
            raise ValueError(f"task granted {dev}, but the payload's "
                             f"weights live on {self.device}")
        return dev

    # -- task functions ---------------------------------------------------

    @torch.no_grad()
    def predict_batch(self, submesh, payload):
        """Score a stack of sequences in one call.

        payload: sequences (R, L) int; target (16,) shared or (R, 16)
        per-row; receptor_len int. Masked mixed-length form: with per-row
        ``seq_lens`` (and optional per-row ``chain_splits``, defaulting to
        ``receptor_len``) the token dim is padded to a length bucket and
        scored by ``foldscore_fwd_masked``.

        Returns {"rows": [per-row metric dicts], "batch": occupancy info
        incl. ``len_occupancy`` = real tokens / padded tokens}."""
        dev = self._task_device(submesh)
        seqs = np.asarray(payload["sequences"], np.int32)
        if seqs.ndim == 1:
            seqs = seqs[None]
        R, L = seqs.shape
        tgt = np.asarray(payload["target"], np.float32)
        if tgt.ndim == 1:
            tgt = np.tile(tgt[None], (R, 1))
        seq_lens = payload.get("seq_lens")
        put = lambda a: torch.tensor(a, device=dev)
        if seq_lens is not None:
            seq_lens = np.asarray(seq_lens, np.int32).reshape(-1)
            splits = np.asarray(
                payload.get("chain_splits",
                            np.full(R, int(payload["receptor_len"]))),
                np.int32).reshape(-1)
            Lb = bucket_len(L, self.length_buckets)
            if Lb > L:
                seqs = np.concatenate(
                    [seqs, np.zeros((R, Lb - L), np.int32)], axis=1)
                L = Lb
            len_occ = float(seq_lens.sum()) / float(R * L)
            (seqs, tgt, seq_lens, splits), B = _pad_rows(
                [seqs, tgt, seq_lens, splits], R)
            m = prot.foldscore_fwd_masked(
                self.fold_params, put(seqs), put(tgt), put(seq_lens),
                put(splits), self.fold_cfg)
        else:
            len_occ = 1.0
            (seqs, tgt), B = _pad_rows([seqs, tgt], R)
            m = prot.foldscore_fwd(self.fold_params, put(seqs), put(tgt),
                                   self.fold_cfg,
                                   chain_split=int(payload["receptor_len"]))
        batch = {"rows": R, "bucket": B, "occupancy": R / B, "devices": 1,
                 "len_occupancy": len_occ}
        return {"rows": prot.metrics_rows(m, R), "batch": batch}

    def generate_batch(self, submesh, payload):
        """Sample a (rows, n, L) candidate stack, one row per pipeline.

        payload: backbones (R, P, 16) f32 (or (P, 16) for one row); seeds
        (R,) per-row seeds; n, length, temperature; ``decode="paged"``
        (the only form ported so far); optional row_lens (R,) true lengths
        (the masked form: ``length`` is the shared bucket), page_size,
        decode_slots, ``_admit`` (the executor's admission port) and
        ``noise`` (R, n, length, padded_vocab) Gumbel draws replacing the
        seeded ones.

        Returns {"rows": [(seqs (n,L) i32, lls (n,) f32) per row],
        "batch": occupancy info, with the engine's decode ``steps`` and row
        ``admits`` for this dispatch}."""
        if payload.get("decode") != "paged":
            raise NotImplementedError(
                "dense generate_batch is not ported yet; pass "
                "decode='paged'")
        return self._generate_batch_paged(submesh, payload)

    def _paged_parse(self, payload, length):
        """Normalize a paged generate payload's per-row arrays."""
        bbs = np.asarray(payload["backbones"], np.float32)
        if bbs.ndim == 2:
            bbs = bbs[None]
        bbs = bbs[:, :self.gen_cfg.frontend_seq]
        seeds = np.asarray(payload["seeds"], np.int64).reshape(-1)
        rl = payload.get("row_lens")
        rl = (np.asarray(rl, np.int32).reshape(-1) if rl is not None
              else np.full(bbs.shape[0], length, np.int32))
        noise = payload.get("noise")
        if noise is not None:
            noise = np.asarray(noise, np.float32)
        return bbs, seeds, rl, noise

    def _engine(self, slots, length, page_size, dev):
        key = (slots, length, page_size)
        with self._engines_lock:
            if key not in self._engines:
                self._engines[key] = prot.PagedDecodeEngine(
                    self.gen_cfg, slots=slots, max_new=length,
                    page_size=page_size, device=dev)
            return self._engines[key]

    def _generate_batch_paged(self, submesh, payload):
        """Continuous batching over a paged KV cache. One engine per (slots,
        length, page size) serves every dispatch. Live admission: with an
        admission port in ``payload["_admit"]`` the engine's poll hook
        pulls compatible queued tasks into the running decode whenever
        slots free up; their rows follow the initial rows in the result."""
        dev = self._task_device(submesh)
        n = int(payload["n"])
        length = int(payload["length"])
        temp = float(payload.get("temperature", 1.0))
        page_size = int(payload.get("page_size", 8))
        port = payload.get("_admit")
        bbs, seeds, row_lens, noise = self._paged_parse(payload, length)
        R0 = bbs.shape[0]
        slots = int(payload.get("decode_slots", 0)) \
            or min(max(R0 * n, 4), 32)
        eng = self._engine(slots, length, page_size, dev)

        records = []           # (tag0, n_rows) in result-row order

        def specs_for(bb, sds, rl, nz, tag0):
            out = []
            for r in range(bb.shape[0]):
                out += [dict(backbone=bb[r], seed=candidate_seed(sds[r], c),
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
                abb, asd, arl, anz = self._paged_parse(t.payload, length)
                out += specs_for(abb, asd, arl, anz, len(admitted))
                occ_rows.append((int(arl.sum()), abb.shape[0]))
            return out

        with eng.lock:
            steps0, admits0 = eng.n_steps, eng.n_admits
            res = eng.run(self.gen_params, temp,
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
        return {"rows": rows, "batch": batch}
