"""The adaptive protein-design protocol (paper §II-C, Fig. 1).

Stages per design cycle:
  1  ProteinMPNN-analogue generates n_candidates sequences for the structure
  2  candidates sorted by log-likelihood                     (host-side)
  3  best candidate compiled into the predict input          (host-side)
  4  AlphaFold-analogue predicts / scores the complex
  5  quality metrics gathered (pLDDT, pTM, inter-chain pAE)
  6  adaptive decision: improved -> accept (structure feeds cycle+1);
     declined -> re-select next-ranked candidate (<= max_reselections);
     exhausted -> prune the trajectory.
  6M+7  after n_cycles accepted cycles the trajectory completes.

Sub-pipelines (paper §II-D): on an accepted cycle, if the runner-up
candidate is within ``runner_up_window`` log-likelihood of the winner, the
protocol proposes a sub-pipeline exploring it as an alternative conformation
— the coordinator submits it only when idle resources exist.

The CONT-V control drops every adaptive element: random candidate choice,
unconditional accept, no re-selection, no pruning, no sub-pipelines
(paper §III-A).

Batched scoring (``score_batch >= 1``): instead of one candidate per
protocol⇄executor round-trip, the top-k ranked candidates are submitted as a
single ``predict_batch`` task and the stage-6 decision walks the returned
score rows in LL order, applying exactly the per-candidate accept /
re-select / prune rules — up to ``max_reselections`` round-trips collapse
into one. With k=1 the batched path reproduces the sequential event sequence
bit-for-bit (tests/test_batched_scoring.py); the CONT-V control is clamped
to k=1. ``score_batch=0`` (default) keeps the seed per-candidate tasks.

Batched generation (``generate_batch_size >= 1``): stage 1 is submitted as a
one-row ``generate_batch`` task instead of a per-pipeline ``generate`` task.
The executor's rolling-admission coalescer stacks compatible rows from other
pipelines into one device batch of up to ``generate_batch_size`` rows;
per-row seeds keep each pipeline's sampling stream, so the protocol decision
sequence is unchanged (tests/test_generate_batching.py). Batched tasks carry
a row footprint (``ResourceRequest.rows``), so the allocator grants a
sub-mesh proportional to the fused batch instead of the fixed
``gen_devices``/``predict_devices`` counts. ``generate_batch_size=0``
(default) keeps the seed per-pipeline path; the CONT-V control always does.

A copy of the JAX package's ``repro.core.protocol`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.api import Decision, DesignProtocol, revive_design_meta
from repro_torch.core.pipeline import Pipeline, ResourceRequest, Task
from repro_torch.runtime.allocator import bucket_len

AA = 20


@dataclass(frozen=True)
class ProtocolConfig:
    n_candidates: int = 10
    max_reselections: int = 10
    n_cycles: int = 4
    adaptive: bool = True
    spawn_sub_pipelines: bool = True
    runner_up_window: float = 3.0     # LL gap for sub-pipeline spawning
    max_sub_pipelines: int = 8
    temperature: float = 1.0
    structure_lr: float = 0.25        # backbone drift toward accepted seq
    gen_devices: int = 2
    predict_devices: int = 1
    seed: int = 0
    score_batch: int = 0  # 0: per-candidate predict tasks (sequential seed
    #                       path); k>=1: top-k batched predict_batch tasks
    generate_batch_size: int = 0  # 0: one generate task per pipeline cycle
    #   (seed path); >=1: coalescable one-row generate_batch tasks that
    #   fuse across pipelines up to this many rows per device batch
    length_buckets: Optional[Tuple[int, ...]] = None
    #   None (default): exact-length tasks — the seed path, bit-for-bit.
    #   A tuple of bucket edges (a mixed-receptor-length campaign; see
    #   repro.session.campaign_length_buckets) switches the batched task
    #   builders to the *masked* payload forms: generate_batch samples at
    #   the bucketed length with a per-row true length, predict_batch
    #   carries per-row seq_lens/chain_splits — so pipelines of different
    #   receptor lengths fuse into one dense device batch. Deterministic
    #   per pipeline: the bucket decision is made here, at task-creation
    #   time, never by what else happens to be queued.
    decode_kernel: bool = False
    #   True stamps batched generate payloads ``decode="paged"`` — they run
    #   as continuous token-level decode over a paged KV cache (the paged
    #   decode kernel, live mid-decode admission) instead of per-row dense
    #   sampling. Requires generate_batch_size >= 1. Sampling streams stay
    #   per-(seed, candidate), so results are batch-composition-independent
    #   (though not bit-identical to the dense path's streams).
    decode_slots: int = 0
    #   Decode slots per paged engine (0: payload picks a default). One
    #   slot holds one (row, candidate) decode stream; admission waits for
    #   a free slot, so more slots = more concurrent streams per device.


def fitness(metrics: Dict[str, float]) -> float:
    """Scalar design quality: pLDDT and pTM up, inter-chain pAE down."""
    return metrics["plddt"] / 100.0 + metrics["ptm"] - metrics["pae"] / 30.0


class ImpressProtocol(DesignProtocol):
    """Pure decision logic: consumes task completions, emits new tasks.
    No threads, no devices — fully unit-testable.

    Task completions are routed through the ``DesignProtocol`` typed
    registry: ``handlers[kind]`` wraps the corresponding ``on_*_done``
    method (kept as the stable, directly-testable decision API) into a
    ``Decision`` for the coordinator."""

    def __init__(self, cfg: ProtocolConfig, feat_dim: int = 16):
        self.cfg = cfg
        self.feat_dim = feat_dim
        rng = np.random.default_rng(cfg.seed + 17)
        # fixed AA embedding used for the structure update (stage 6 -> 1 loop)
        self._aa_emb = rng.normal(size=(AA + 12, feat_dim)).astype(np.float32)
        self.n_sub_spawned = 0
        self.handlers = {
            "generate": self._route_generate,
            "generate_batch": self._route_generate_batch,
            "predict": self._route_predict,
            "predict_batch": self._route_predict_batch,
        }

    # -- typed completion routing (DesignProtocol.handlers) ----------------

    def _route_generate(self, pl: Pipeline, result) -> Decision:
        return Decision(tasks=self.on_generate_done(pl, result))

    def _route_generate_batch(self, pl: Pipeline, result) -> Decision:
        return Decision(tasks=self.on_generate_batch_done(pl, result))

    def _route_predict(self, pl: Pipeline, result) -> Decision:
        return self._to_decision(pl, self.on_predict_done(pl, result))

    def _route_predict_batch(self, pl: Pipeline, result) -> Decision:
        return self._to_decision(pl, self.on_predict_batch_done(pl, result))

    def _to_decision(self, pl: Pipeline, out: Dict[str, Any]) -> Decision:
        """Stage-6 outcome dict -> Decision. Accepted designs are the §V
        training data ("completed" is the final accepted cycle), declared
        explicitly so the coordinator needs no event-name knowledge."""
        d = Decision(tasks=out["tasks"], spawn=out["spawn"],
                     events=out.get("events",
                                    [{"event": out["event"],
                                      "cycle": pl.cycle}]))
        if out["event"] in ("accepted", "completed") and pl.history:
            d.accepted_design = pl.history[-1]
        return d

    # -- pipeline bootstrap ------------------------------------------------

    def new_pipeline(self, name: str, backbone: np.ndarray,
                     target: np.ndarray, receptor_len: int,
                     peptide_tokens: Optional[np.ndarray] = None,
                     parent: Optional[int] = None,
                     seed_candidate: Optional[dict] = None) -> Pipeline:
        if peptide_tokens is None:
            peptide_tokens = np.arange(1, 7, dtype=np.int32)
        pl = Pipeline(name=name, parent=parent, meta={
            "backbone": np.asarray(backbone, np.float32),
            "target": np.asarray(target, np.float32),
            "peptide_tokens": np.asarray(peptide_tokens, np.int32),
            "receptor_len": int(receptor_len),
            "prev_fitness": None,
            "candidates": None,       # (seqs (n,L), lls (n,)) sorted
            "cand_idx": 0,
            "reselections": 0,
            "trajectories": 0,
            "gen_version": 0,         # generator version that produced the
            #   current candidates (provenance; updated per generate result)
        })
        if seed_candidate is not None:
            pl.meta["candidates"] = seed_candidate
        return pl

    def first_task(self, pl: Pipeline) -> Task:
        if pl.meta["candidates"] is not None:   # sub-pipeline: jump to stage 4
            return self._next_predict_task(pl)
        return self._generate_task(pl)

    # -- task builders -----------------------------------------------------

    def _generate_task(self, pl: Pipeline) -> Task:
        """Stage-1 task. Seed path: a per-pipeline ``generate`` on the fixed
        ``gen_devices`` sub-mesh. Batched path (``generate_batch_size >= 1``,
        adaptive only — CONT-V stays sequential): a one-row
        ``generate_batch`` that the executor may stack with other pipelines'
        rows; ``rows=1`` makes the allocator size the sub-mesh by the fused
        batch, floored at one device."""
        c = self.cfg
        seed = c.seed + 1000 * pl.uid + pl.cycle
        if c.generate_batch_size >= 1 and c.adaptive:
            L = int(pl.meta["receptor_len"])
            payload = {
                "backbones": pl.meta["backbone"][None],
                "seeds": [seed],
                "n": c.n_candidates,
                "length": L,
                "temperature": c.temperature,
            }
            if c.length_buckets:
                # masked form: sample at the bucket edge, truncate to the
                # true length — so different-length pipelines share a key
                payload["length"] = bucket_len(L, c.length_buckets)
                payload["row_lens"] = [L]
            if c.decode_kernel:
                payload["decode"] = "paged"
                if c.decode_slots:
                    payload["decode_slots"] = c.decode_slots
            return Task(kind="generate_batch", pipeline_id=pl.uid,
                        payload=payload,
                        resources=ResourceRequest(n_devices=1, rows=1))
        return Task(kind="generate", pipeline_id=pl.uid, payload={
            "backbone": pl.meta["backbone"],
            "n": c.n_candidates,
            "length": pl.meta["receptor_len"],
            "temperature": c.temperature,
            "seed": seed,
        }, resources=ResourceRequest(n_devices=c.gen_devices))

    def _predict_task(self, pl: Pipeline) -> Task:
        seqs, lls = pl.meta["candidates"]
        i = pl.meta["cand_idx"]
        # stage 3: compile receptor design + fixed target peptide (the
        # "fasta" input) for the structure-prediction task
        complex_seq = np.concatenate(
            [np.asarray(seqs[i], np.int32), pl.meta["peptide_tokens"]])
        payload = {
            "sequence": complex_seq,
            "target": pl.meta["target"],
            "receptor_len": pl.meta["receptor_len"],
        }
        if self.cfg.length_buckets:
            # masked form: the payload pads to the length bucket and scores
            # with the shared predict_mb1_L{bucket} executable instead of
            # minting one per exact complex length
            payload["seq_len"] = int(complex_seq.shape[0])
        return Task(kind="predict", pipeline_id=pl.uid, payload=payload,
                    resources=ResourceRequest(
                        n_devices=self.cfg.predict_devices))

    def _batch_k(self, pl: Pipeline) -> int:
        """Rows for the next predict_batch: the configured top-k, capped by
        the candidates left and the remaining re-selection budget (scoring
        past the prune point would be pure waste). CONT-V accepts the first
        candidate unconditionally, so the control stays k=1 sequential."""
        c = self.cfg
        if not c.adaptive:
            return 1
        seqs, _ = pl.meta["candidates"]
        left = len(seqs) - pl.meta["cand_idx"]
        budget = c.max_reselections - pl.meta["reselections"] + 1
        return max(1, min(c.score_batch, left, budget))

    def _predict_batch_task(self, pl: Pipeline) -> Task:
        seqs, lls = pl.meta["candidates"]
        i = pl.meta["cand_idx"]
        k = self._batch_k(pl)
        pep = pl.meta["peptide_tokens"]
        stack = np.stack([np.concatenate(
            [np.asarray(seqs[i + r], np.int32), pep]) for r in range(k)])
        payload = {
            "sequences": stack,
            "target": pl.meta["target"],
            "receptor_len": pl.meta["receptor_len"],
        }
        if self.cfg.length_buckets:
            # masked form: per-row true lengths/splits ride along so the
            # payload pads to the length bucket and fuses across pipelines
            # of different receptor lengths
            payload["seq_lens"] = np.full(k, stack.shape[1], np.int32)
            payload["chain_splits"] = np.full(
                k, int(pl.meta["receptor_len"]), np.int32)
        return Task(kind="predict_batch", pipeline_id=pl.uid,
                    payload=payload,
                    resources=ResourceRequest(
                        n_devices=self.cfg.predict_devices, rows=k))

    def _next_predict_task(self, pl: Pipeline) -> Task:
        return (self._predict_batch_task(pl) if self.cfg.score_batch >= 1
                else self._predict_task(pl))

    # -- completions ---------------------------------------------------------

    def on_generate_done(self, pl: Pipeline, result) -> List[Task]:
        """Stages 2+3: rank by LL (adaptive) or shuffle (control).
        ``result`` is either the legacy (seqs, lls) tuple or a dict
        {"seqs", "lls", "gen_version"} — the dict form records which
        generator version produced the candidates (provenance)."""
        if isinstance(result, dict):
            pl.meta["gen_version"] = int(result.get("gen_version", 0))
            result = (result["seqs"], result["lls"])
        seqs, lls = result                    # (n,L), (n,)
        order = (np.argsort(-lls) if self.cfg.adaptive
                 else np.random.default_rng(self.cfg.seed + pl.uid
                                            + pl.cycle).permutation(len(lls)))
        pl.meta["candidates"] = (np.asarray(seqs)[order], np.asarray(lls)[order])
        pl.meta["cand_idx"] = 0
        pl.meta["reselections"] = 0
        return [self._next_predict_task(pl)]

    def on_generate_batch_done(self, pl: Pipeline, result) -> List[Task]:
        """Completion of this pipeline's row of a (possibly fused)
        ``generate_batch``: unwrap the single row and apply the stage-2+3
        ranking exactly as a ``generate`` completion would."""
        rows = result["rows"] if isinstance(result, dict) else list(result)
        if len(rows) != 1:
            raise ValueError(
                f"pipeline {pl.uid} expected its own generate_batch row, "
                f"got {len(rows)}")
        if isinstance(result, dict) and "gen_version" in result:
            pl.meta["gen_version"] = int(result["gen_version"])
        seqs, lls = rows[0]
        return self.on_generate_done(pl, (seqs, lls))

    def on_predict_done(self, pl: Pipeline, metrics: Dict[str, float]
                        ) -> Dict[str, Any]:
        """Stage 6 decision for one scored candidate. Returns dict with keys:
        tasks: List[Task]; spawn: Optional[sub-pipeline proposal];
        event: accepted | reselect | pruned | completed;
        events: [{event, cycle}] (the post-decision cycle)."""
        out = self._decide(pl, metrics)
        if out["event"] == "reselect":
            out["tasks"] = [self._predict_task(pl)]
        out["events"] = [{"event": out["event"], "cycle": pl.cycle}]
        return out

    def on_predict_batch_done(self, pl: Pipeline, result) -> Dict[str, Any]:
        """Stage 6 decision over a batched top-k score vector: walk the rows
        in LL order applying the per-candidate rules until one is accepted
        (later rows are discarded speculation) or the batch is exhausted —
        then the next top-k batch is submitted. ``events`` carries the
        per-row event sequence; ``event`` the last one."""
        rows = result["rows"] if isinstance(result, dict) else list(result)
        if not rows:
            raise ValueError("predict_batch completed with no score rows")
        events: List[dict] = []
        out: Dict[str, Any] = {}
        for metrics in rows:
            out = self._decide(pl, metrics)
            # stamp each row with its own post-decision cycle, exactly as
            # the sequential path would have logged it
            events.append({"event": out["event"], "cycle": pl.cycle})
            if out["event"] != "reselect":
                break
        if out.get("event") == "reselect":  # batch exhausted, budget left
            out["tasks"] = [self._predict_batch_task(pl)]
        out["events"] = events
        return out

    def _decide(self, pl: Pipeline, metrics: Dict[str, float]
                ) -> Dict[str, Any]:
        """The per-candidate accept / re-select / prune rule — shared by the
        sequential and batched paths so both make identical decisions.
        'reselect' outcomes return ``tasks=[]``; the caller decides whether
        the next candidate costs a round-trip or is the next batch row."""
        c = self.cfg
        pl.meta["trajectories"] += 1
        fit = fitness(metrics)
        prev = pl.meta["prev_fitness"]
        improved = (prev is None) or (fit > prev) or not c.adaptive

        if not improved:
            pl.meta["reselections"] += 1
            pl.meta["cand_idx"] += 1
            seqs, _ = pl.meta["candidates"]
            if (pl.meta["reselections"] <= c.max_reselections
                    and pl.meta["cand_idx"] < len(seqs)):
                return {"tasks": [], "spawn": None, "event": "reselect"}
            pl.active = False
            return {"tasks": [], "spawn": None, "event": "pruned"}

        # accepted: record (incl. the design itself — accepted designs are
        # the training data for §V model evolution), update structure,
        # advance the cycle
        seqs, lls = pl.meta["candidates"]
        chosen = seqs[pl.meta["cand_idx"]]
        pl.history.append(dict(
            metrics, fitness=fit, cycle=pl.cycle,
            cand_idx=pl.meta["cand_idx"],
            sequence=np.asarray(chosen).tolist(),
            backbone=np.asarray(pl.meta["backbone"]).tolist(),
            gen_version=int(pl.meta.get("gen_version", 0))))
        pl.meta["prev_fitness"] = fit
        self._update_structure(pl, chosen)

        spawn = None
        if (c.adaptive and c.spawn_sub_pipelines
                and self.n_sub_spawned < c.max_sub_pipelines
                and pl.meta["cand_idx"] + 1 < len(seqs)):
            j = pl.meta["cand_idx"] + 1
            if abs(float(lls[pl.meta["cand_idx"]] - lls[j])) <= c.runner_up_window:
                spawn = {
                    "name": f"{pl.name}/sub{self.n_sub_spawned}",
                    "backbone": pl.meta["backbone"].copy(),
                    "target": pl.meta["target"],
                    "receptor_len": pl.meta["receptor_len"],
                    "peptide_tokens": pl.meta["peptide_tokens"],
                    "parent": pl.uid,
                    "seed_candidate": (seqs[j:], lls[j:]),
                    "cycle": pl.cycle,
                    # sub-pipelines refine: they must beat the parent's
                    # accepted quality, not restart from scratch
                    "prev_fitness": fit,
                    # seeded candidates inherit the parent's provenance
                    "gen_version": int(pl.meta.get("gen_version", 0)),
                }

        pl.cycle += 1
        if pl.cycle >= c.n_cycles:
            pl.active = False
            return {"tasks": [], "spawn": spawn, "event": "completed"}
        return {"tasks": [self._generate_task(pl)], "spawn": spawn,
                "event": "accepted"}

    def register_sub_spawn(self):
        self.n_sub_spawned += 1

    # -- sub-pipelines (DesignProtocol hooks) --------------------------------

    def can_spawn(self) -> bool:
        return self.n_sub_spawned < self.cfg.max_sub_pipelines

    def spawn_pipeline(self, spawn: dict) -> Optional[Pipeline]:
        """Materialize a runner-up spawn proposal (built by ``_decide``)
        into a sub-pipeline, inheriting the parent's cycle, accepted
        fitness bar, and generator provenance."""
        sub = self.new_pipeline(
            spawn["name"], spawn["backbone"], spawn["target"],
            spawn["receptor_len"],
            peptide_tokens=spawn.get("peptide_tokens"),
            parent=spawn["parent"],
            seed_candidate=spawn["seed_candidate"])
        sub.cycle = spawn.get("cycle", 0)
        if spawn.get("prev_fitness") is not None:
            sub.meta["prev_fitness"] = spawn["prev_fitness"]
        sub.meta["gen_version"] = spawn.get("gen_version", 0)
        self.register_sub_spawn()
        return sub

    # -- checkpoint (DesignProtocol hooks) -----------------------------------

    def state_dict(self) -> dict:
        return {"n_sub_spawned": self.n_sub_spawned}

    def load_state_dict(self, state: dict) -> None:
        self.n_sub_spawned = state["n_sub_spawned"]

    def revive_meta(self, meta: dict) -> dict:
        return revive_design_meta(meta)

    # -- structure feedback (stage 6 -> stage 1 loop) ------------------------

    def _update_structure(self, pl: Pipeline, seq: np.ndarray):
        """The accepted AlphaFold model feeds the next ProteinMPNN cycle:
        receptor backbone features drift toward the accepted sequence's
        embedding (deterministic stand-in for the predicted structure)."""
        bb = pl.meta["backbone"]
        R = int(pl.meta["receptor_len"])
        emb = self._aa_emb[np.asarray(seq[:R]) % self._aa_emb.shape[0]]
        lr = self.cfg.structure_lr
        bb = bb.copy()
        bb[:R] = (1 - lr) * bb[:R] + lr * emb
        pl.meta["backbone"] = bb
