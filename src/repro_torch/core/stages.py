"""Heterogeneous multi-stage binder pipelines (stage tables + protocols).

The IMPRESS protocol treats "generate" and "predict" as an implicit
two-stage loop with one model each. Real binder-design campaigns are
*staged*: a cheap, wide backbone-sampling stage (RFdiffusion-style) feeds
a sequence-design stage (ProteinMPNN-style), which feeds an expensive
fold/score stage (AlphaFold-Multimer-style) — three models, three resource
profiles, three batching regimes. This module makes that structure a
first-class, declarative object:

``StageSpec``
    One row of a protocol's stage table: which task kind the stage
    submits, which param-set namespace it draws from
    (``ProteinPayload.add_generator`` / ``add_scorer``), its scheduler
    priority band + weighted-fair share, its device footprint, and its
    per-stage coalesce knobs (``max_rows`` / ``admission_window``).

``StagedBinderProtocol``
    A ``DesignProtocol`` that runs backbone-sample -> sequence-design ->
    fold/score as three distinct task stages per design cycle. It plugs
    into the unmodified ``Coordinator`` exactly like ``ImpressProtocol``
    does — the stage machinery is carried entirely by the tasks it emits
    (``Task.stage`` / ``Task.band`` / ``payload["params"]``), which the
    runtime layer already understands:

      * the executor's coalescer fuses same-stage tasks across pipelines
        AND protocols, and never fuses across stages;
      * the ``TaskQueue`` divides dispatches across priority bands by the
        stage table's shares (``AsyncExecutor(band_shares=...)``), so the
        heavy fold stage cannot starve the cheap sampling stages;
      * the allocator accounts grants per stage
        (``DeviceAllocator.stage_shape_stats`` / ``stage_utilization``).

``RescoreProtocol``
    A deliberately boring co-tenant: pipelines that flood the fold stage
    with batched rescoring work. It exists for fairness benchmarks and
    tests (a fold flood next to a sampling trickle) — all of its load
    flows through a protocol binding, so the coordinator's inflight
    accounting stays exact.

Determinism: every sampling seed derives from ``pl.meta["seed0"]``, which
is assigned from a *per-protocol creation counter* at ``new_pipeline``
time — never from the global ``Pipeline.uid`` — so a pipeline's stream is
identical whether its campaign runs solo or fused with other protocols
(composition independence, tests/test_stages.py).

A copy of the JAX package's ``repro.core.stages`` (free of JAX
there too), with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.api import Decision, DesignProtocol, revive_design_meta
from repro_torch.core.pipeline import Pipeline, ResourceRequest, Task
from repro_torch.core.protocol import AA, fitness
from repro_torch.runtime.allocator import bucket_len


@dataclass(frozen=True)
class StageSpec:
    """One stage of a heterogeneous pipeline: task kind + param namespace
    + scheduling class + coalesce knobs. The table a protocol exposes via
    ``DesignProtocol.stage_specs()`` is what the session facade wires into
    the payload registry (param namespaces, per-stage coalesce rules) and
    the task queue (band shares)."""
    name: str                 # stage label stamped on Task.stage
    kind: str                 # registered payload task kind
    params: str = "default"   # param-set namespace (payload["params"])
    band: int = 0             # scheduler priority band (Task.band)
    share: float = 1.0        # weighted-fair share of the band
    n_devices: int = 1        # sub-mesh floor for this stage's tasks
    rows: Optional[int] = None    # row-footprint override (None: natural)
    max_rows: Optional[int] = None         # per-stage fused-batch cap
    admission_window: Optional[float] = None   # per-stage coalesce wait


def default_binder_stages() -> Tuple[StageSpec, ...]:
    """The canonical three-stage binder table: wide cheap backbone
    sampling and sequence design on band 0; the heavy multimer fold/score
    stage on band 1 with an equal share — fold work can neither starve nor
    be starved by the sampling stages. ``seqdesign`` and ``fold`` each
    draw from their own param-set namespace ("binder" generator, the
    ``foldscore-m`` "multimer" scorer), so the table exercises two extra
    param sets beyond the default pair."""
    return (
        StageSpec(name="backbone", kind="backbone_batch", band=0),
        StageSpec(name="seqdesign", kind="generate_batch",
                  params="binder", band=0),
        StageSpec(name="fold", kind="predict_batch",
                  params="multimer", band=1),
    )


@dataclass(frozen=True)
class BinderConfig:
    """Knobs for ``StagedBinderProtocol``; mirrors ``ProtocolConfig``
    where the semantics coincide."""
    n_backbones: int = 8          # candidate backbones per backbone stage
    backbone_sigma: float = 0.1   # backbone perturbation scale
    n_candidates: int = 6         # sequences per design stage
    score_batch: int = 2          # top-k candidates folded per fold task
    n_cycles: int = 3
    max_reselections: int = 6
    structure_lr: float = 0.25    # accepted-sequence backbone drift
    temperature: float = 1.0
    seed: int = 0
    length_buckets: Optional[Tuple[int, ...]] = None
    stages: Tuple[StageSpec, ...] = ()   # () -> default_binder_stages()


class StagedBinderProtocol(DesignProtocol):
    """Backbone-sample -> sequence-design -> fold/score, one cycle per
    accepted design, through the unmodified coordinator.

    Per cycle:
      1  backbone stage: perturb the working backbone into ``n_backbones``
         candidates, keep the best target-fit one (the working structure
         for this cycle's sequence design)
      2  seqdesign stage: sample ``n_candidates`` sequences on that
         backbone from the stage's own generator namespace; rank by LL
      3  fold stage: score the top-k as one batched task with the stage's
         scorer namespace; walk rows in LL order applying the IMPRESS
         accept / re-select / prune rule (shared ``fitness``)
      4  accepted: record the design, drift the backbone toward the
         accepted sequence, next cycle (or complete after ``n_cycles``)

    All three stages are batched kinds carrying row footprints, so tasks
    from many binder pipelines — and from other protocols sharing a stage
    label — fuse into dense device batches."""

    def __init__(self, cfg: BinderConfig, feat_dim: int = 16):
        self.cfg = cfg
        self.feat_dim = feat_dim
        stages = tuple(cfg.stages) or default_binder_stages()
        kinds = [s.kind for s in stages]
        if len(stages) != 3 or sorted(kinds) != [
                "backbone_batch", "generate_batch", "predict_batch"]:
            raise ValueError(
                "StagedBinderProtocol needs exactly one stage each of "
                "backbone_batch / generate_batch / predict_batch, got "
                f"{kinds}")
        self.stages = stages
        self._by_kind = {s.kind: s for s in stages}
        rng = np.random.default_rng(cfg.seed + 17)
        self._aa_emb = rng.normal(
            size=(AA + 12, feat_dim)).astype(np.float32)
        self._n_created = 0   # per-protocol pipeline counter -> seed0
        self.handlers = {
            "backbone_batch": self._route_backbone,
            "generate_batch": self._route_generate,
            "predict_batch": self._route_predict,
        }

    def stage_specs(self) -> Tuple[StageSpec, ...]:
        return self.stages

    # -- pipeline bootstrap ------------------------------------------------

    def new_pipeline(self, name: str, backbone: np.ndarray,
                     target: np.ndarray, receptor_len: int,
                     peptide_tokens: Optional[np.ndarray] = None,
                     parent: Optional[int] = None) -> Pipeline:
        if peptide_tokens is None:
            peptide_tokens = np.arange(1, 7, dtype=np.int32)
        # seed0 comes from this protocol's own creation counter, NOT the
        # global pipeline uid: uids shift when other protocols create
        # pipelines first, and seeds must not
        seed0 = self.cfg.seed + 7919 * self._n_created
        self._n_created += 1
        return Pipeline(name=name, parent=parent, meta={
            "backbone": np.asarray(backbone, np.float32),
            "target": np.asarray(target, np.float32),
            "peptide_tokens": np.asarray(peptide_tokens, np.int32),
            "receptor_len": int(receptor_len),
            "seed0": int(seed0),
            "prev_fitness": None,
            "backbone_fit": None,     # best target-fit of the last stage 1
            "candidates": None,       # (seqs (n,L), lls (n,)) sorted
            "cand_idx": 0,
            "reselections": 0,
            "trajectories": 0,
            "gen_version": 0,
            "stage_cursor": "backbone_batch",  # next task kind to submit:
            #   each route handler advances it, so a pipeline checkpointed
            #   mid-cycle (e.g. with a fold task inflight) resumes at the
            #   exact stage it stopped at instead of redoing the cycle's
            #   backbone stage — whose route *mutates* meta["backbone"],
            #   so redoing it would fork the design trajectory
        })

    def first_task(self, pl: Pipeline) -> Task:
        cursor = pl.meta.get("stage_cursor", "backbone_batch")
        if cursor == "generate_batch":
            return self._design_task(pl)
        if cursor == "predict_batch":
            return self._fold_task(pl)
        return self._backbone_task(pl)   # fresh pipeline / legacy state

    # -- task factories ----------------------------------------------------

    def _stamp(self, task: Task, spec: StageSpec, rows: int) -> Task:
        """Apply one stage's scheduling class to a task: stage label +
        band for the queue/coalescer, namespace for the payload, row
        footprint for the allocator."""
        task.stage = spec.name
        task.band = spec.band
        if spec.params != "default":
            task.payload["params"] = spec.params
        task.resources = ResourceRequest(
            n_devices=spec.n_devices,
            rows=spec.rows if spec.rows is not None else rows)
        return task

    def _seed(self, pl: Pipeline, offset: int) -> int:
        return int(pl.meta["seed0"]) + 131 * pl.cycle + offset

    def _backbone_task(self, pl: Pipeline) -> Task:
        spec = self._by_kind["backbone_batch"]
        t = Task(kind="backbone_batch", pipeline_id=pl.uid, payload={
            "bases": pl.meta["backbone"][None],
            "targets": pl.meta["target"][None],
            "seeds": [self._seed(pl, 0)],
            "m": self.cfg.n_backbones,
            "sigma": self.cfg.backbone_sigma,
        })
        return self._stamp(t, spec, rows=1)

    def _design_task(self, pl: Pipeline) -> Task:
        spec = self._by_kind["generate_batch"]
        c = self.cfg
        L = int(pl.meta["receptor_len"])
        payload = {
            "backbones": pl.meta["backbone"][None],
            "seeds": [self._seed(pl, 1)],
            "n": c.n_candidates,
            "length": L,
            "temperature": c.temperature,
        }
        if c.length_buckets:
            payload["length"] = bucket_len(L, c.length_buckets)
            payload["row_lens"] = [L]
        t = Task(kind="generate_batch", pipeline_id=pl.uid, payload=payload)
        return self._stamp(t, spec, rows=1)

    def _fold_task(self, pl: Pipeline) -> Task:
        spec = self._by_kind["predict_batch"]
        c = self.cfg
        seqs, _ = pl.meta["candidates"]
        i = pl.meta["cand_idx"]
        left = len(seqs) - i
        budget = c.max_reselections - pl.meta["reselections"] + 1
        k = max(1, min(c.score_batch, left, budget))
        pep = pl.meta["peptide_tokens"]
        stack = np.stack([np.concatenate(
            [np.asarray(seqs[i + r], np.int32), pep]) for r in range(k)])
        payload = {
            "sequences": stack,
            "target": pl.meta["target"],
            "receptor_len": pl.meta["receptor_len"],
        }
        if c.length_buckets:
            payload["seq_lens"] = np.full(k, stack.shape[1], np.int32)
            payload["chain_splits"] = np.full(
                k, int(pl.meta["receptor_len"]), np.int32)
        t = Task(kind="predict_batch", pipeline_id=pl.uid, payload=payload)
        return self._stamp(t, spec, rows=k)

    # -- completions -------------------------------------------------------

    def _route_backbone(self, pl: Pipeline, result) -> Decision:
        """Stage 1 done: keep the best-fit candidate backbone as the
        working structure for this cycle's sequence design."""
        rows = result["rows"] if isinstance(result, dict) else list(result)
        if len(rows) != 1:
            raise ValueError(
                f"pipeline {pl.uid} expected its own backbone_batch row, "
                f"got {len(rows)}")
        cands, scores = rows[0]
        best = int(np.argmax(scores))
        pl.meta["backbone"] = np.asarray(cands[best], np.float32)
        pl.meta["backbone_fit"] = float(scores[best])
        pl.meta["stage_cursor"] = "generate_batch"
        return Decision(tasks=[self._design_task(pl)])

    def _route_generate(self, pl: Pipeline, result) -> Decision:
        """Stage 2 done: rank candidates by log-likelihood, fold the
        top-k."""
        rows = result["rows"] if isinstance(result, dict) else list(result)
        if len(rows) != 1:
            raise ValueError(
                f"pipeline {pl.uid} expected its own generate_batch row, "
                f"got {len(rows)}")
        if isinstance(result, dict) and "gen_version" in result:
            pl.meta["gen_version"] = int(result["gen_version"])
        seqs, lls = rows[0]
        order = np.argsort(-np.asarray(lls))
        pl.meta["candidates"] = (np.asarray(seqs)[order],
                                 np.asarray(lls)[order])
        pl.meta["cand_idx"] = 0
        pl.meta["reselections"] = 0
        pl.meta["stage_cursor"] = "predict_batch"
        return Decision(tasks=[self._fold_task(pl)])

    def _route_predict(self, pl: Pipeline, result) -> Decision:
        """Stage 3 done: walk the batched score rows in LL order with the
        IMPRESS accept / re-select / prune rule."""
        rows = result["rows"] if isinstance(result, dict) else list(result)
        if not rows:
            raise ValueError("fold stage completed with no score rows")
        events: List[dict] = []
        out: Dict[str, Any] = {}
        for metrics in rows:
            out = self._decide(pl, metrics)
            events.append({"event": out["event"], "cycle": pl.cycle})
            if out["event"] != "reselect":
                break
        if out.get("event") == "reselect":   # batch exhausted, budget left
            out["tasks"] = [self._fold_task(pl)]
        d = Decision(tasks=out["tasks"], events=events)
        if out["event"] in ("accepted", "completed") and pl.history:
            d.accepted_design = pl.history[-1]
        return d

    def _decide(self, pl: Pipeline, metrics: Dict[str, float]
                ) -> Dict[str, Any]:
        c = self.cfg
        pl.meta["trajectories"] += 1
        fit = fitness(metrics)
        prev = pl.meta["prev_fitness"]
        improved = (prev is None) or (fit > prev)

        if not improved:
            pl.meta["reselections"] += 1
            pl.meta["cand_idx"] += 1
            seqs, _ = pl.meta["candidates"]
            if (pl.meta["reselections"] <= c.max_reselections
                    and pl.meta["cand_idx"] < len(seqs)):
                return {"tasks": [], "event": "reselect"}
            pl.active = False
            return {"tasks": [], "event": "pruned"}

        seqs, lls = pl.meta["candidates"]
        chosen = seqs[pl.meta["cand_idx"]]
        pl.history.append(dict(
            metrics, fitness=fit, cycle=pl.cycle,
            cand_idx=pl.meta["cand_idx"],
            backbone_fit=pl.meta["backbone_fit"],
            sequence=np.asarray(chosen).tolist(),
            backbone=np.asarray(pl.meta["backbone"]).tolist(),
            gen_version=int(pl.meta.get("gen_version", 0))))
        pl.meta["prev_fitness"] = fit
        self._update_structure(pl, chosen)

        pl.cycle += 1
        if pl.cycle >= c.n_cycles:
            pl.active = False
            return {"tasks": [], "event": "completed"}
        pl.meta["stage_cursor"] = "backbone_batch"
        return {"tasks": [self._backbone_task(pl)], "event": "accepted"}

    def _update_structure(self, pl: Pipeline, seq: np.ndarray):
        """Accepted-sequence feedback, as in ``ImpressProtocol``: receptor
        backbone features drift toward the accepted sequence embedding —
        the next cycle's backbone stage samples around the new point."""
        bb = pl.meta["backbone"].copy()
        R = int(pl.meta["receptor_len"])
        emb = self._aa_emb[np.asarray(seq[:R]) % self._aa_emb.shape[0]]
        lr = self.cfg.structure_lr
        bb[:R] = (1 - lr) * bb[:R] + lr * emb
        pl.meta["backbone"] = bb

    # -- checkpoint (DesignProtocol hooks) ---------------------------------

    def state_dict(self) -> dict:
        return {"n_created": self._n_created}

    def load_state_dict(self, state: dict) -> None:
        self._n_created = state["n_created"]

    def revive_meta(self, meta: dict) -> dict:
        return revive_design_meta(meta)


@dataclass(frozen=True)
class RescoreConfig:
    """Config for the fold-flood co-tenant protocol."""
    n_rounds: int = 4        # predict_batch tasks per pipeline
    rows: int = 4            # candidate rows per task
    params: str = "multimer"  # scorer namespace; matches the default
    #   binder fold stage so co-tenant tasks can fuse with it
    stage: str = "fold"      # stage label (co-tenants a binder fold stage)
    band: int = 1
    n_devices: int = 1
    seed: int = 0
    length_buckets: Optional[Tuple[int, ...]] = None
    max_rows: Optional[int] = None   # fold-dispatch row cap (device-memory
    #   bound); None = the rule's default


class RescoreProtocol(DesignProtocol):
    """Batched-rescoring flood: each pipeline submits ``n_rounds``
    fold-stage ``predict_batch`` tasks over host-random candidate stacks,
    one after another, recording the mean fitness per round. No adaptive
    logic — this protocol exists to put controllable, protocol-bound load
    on one stage for fairness benchmarks and tests (raw executor submits
    during a coordinator run would corrupt its inflight accounting; a
    protocol binding keeps it exact)."""

    def __init__(self, cfg: RescoreConfig):
        self.cfg = cfg
        self._n_created = 0
        self.handlers = {"predict_batch": self._route_predict_batch}

    def stage_specs(self) -> Tuple[StageSpec, ...]:
        return (StageSpec(name=self.cfg.stage, kind="predict_batch",
                          params=self.cfg.params, band=self.cfg.band,
                          n_devices=self.cfg.n_devices,
                          max_rows=self.cfg.max_rows),)

    def new_pipeline(self, name: str, backbone: np.ndarray,
                     target: np.ndarray, receptor_len: int,
                     peptide_tokens: Optional[np.ndarray] = None,
                     parent: Optional[int] = None) -> Pipeline:
        if peptide_tokens is None:
            peptide_tokens = np.arange(1, 7, dtype=np.int32)
        seed0 = self.cfg.seed + 7919 * self._n_created
        self._n_created += 1
        return Pipeline(name=name, parent=parent, meta={
            "backbone": np.asarray(backbone, np.float32),
            "target": np.asarray(target, np.float32),
            "peptide_tokens": np.asarray(peptide_tokens, np.int32),
            "receptor_len": int(receptor_len),
            "seed0": int(seed0),
            "rounds_done": 0,
        })

    def first_task(self, pl: Pipeline) -> Task:
        return self._rescore_task(pl)

    def _rescore_task(self, pl: Pipeline) -> Task:
        c = self.cfg
        R = int(pl.meta["receptor_len"])
        pep = pl.meta["peptide_tokens"]
        W = R + int(pep.shape[0])
        rng = np.random.default_rng(
            int(pl.meta["seed0"]) + pl.meta["rounds_done"])
        stack = rng.integers(1, AA + 1, size=(c.rows, W)).astype(np.int32)
        stack[:, R:] = pep[None]
        payload = {
            "sequences": stack,
            "target": pl.meta["target"],
            "receptor_len": R,
        }
        if c.length_buckets:
            payload["seq_lens"] = np.full(c.rows, W, np.int32)
            payload["chain_splits"] = np.full(c.rows, R, np.int32)
        if c.params != "default":
            payload["params"] = c.params
        t = Task(kind="predict_batch", pipeline_id=pl.uid, payload=payload)
        t.stage = c.stage
        t.band = c.band
        t.resources = ResourceRequest(n_devices=c.n_devices, rows=c.rows)
        return t

    def _route_predict_batch(self, pl: Pipeline, result) -> Decision:
        rows = result["rows"] if isinstance(result, dict) else list(result)
        fits = [fitness(m) for m in rows]
        pl.meta["rounds_done"] += 1
        # batch-mean metrics in the standard history-row shape, so the
        # coordinator's per-cycle quality stats apply unchanged
        pl.history.append({
            "round": pl.meta["rounds_done"],
            "fitness": float(np.mean(fits)),
            "best_fitness": float(np.max(fits)),
            "plddt": float(np.mean([m["plddt"] for m in rows])),
            "ptm": float(np.mean([m["ptm"] for m in rows])),
            "pae": float(np.mean([m["pae"] for m in rows])),
            "cycle": pl.cycle,
        })
        pl.cycle += 1
        if pl.meta["rounds_done"] >= self.cfg.n_rounds:
            pl.active = False
            return Decision(events=[{"event": "completed",
                                     "cycle": pl.cycle}])
        return Decision(tasks=[self._rescore_task(pl)],
                        events=[{"event": "rescored", "cycle": pl.cycle}])

    def revive_meta(self, meta: dict) -> dict:
        meta = dict(meta)
        meta["backbone"] = np.asarray(meta["backbone"], np.float32)
        meta["target"] = np.asarray(meta["target"], np.float32)
        if meta.get("peptide_tokens") is not None:
            meta["peptide_tokens"] = np.asarray(
                meta["peptide_tokens"], np.int32)
        return meta
