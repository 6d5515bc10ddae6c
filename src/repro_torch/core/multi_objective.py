"""A Pareto multi-objective design protocol — the pluggability demo.

Implemented purely against the ``DesignProtocol`` interface (``core/api.py``)
without touching the coordinator: it declares its task-completion handlers,
its task factories, and its checkpoint hooks, and the same middleware that
runs IM-RP / CONT-V runs it unchanged — the ROADMAP's "as many scenarios as
you can imagine" exercised with a genuinely different accept rule.

Where IMPRESS collapses quality into one scalar (``fitness``) and accepts
only strict improvements, this protocol treats (pLDDT ↑, pTM ↑, pAE ↓) as
separate objectives and accepts any candidate that is **not Pareto-dominated
by a previously accepted design** of its pipeline — it grows a
non-dominated front instead of hill-climbing a scalar, the shape of binder
/ multi-objective campaigns (AutoBinder-style scenarios). Dominated
candidates are re-selected in LL order up to ``max_declines``; exhaustion
prunes the trajectory; ``n_cycles`` accepted designs complete it. No
sub-pipelines — the front itself holds the alternatives.

Reuses the stock ``generate`` / ``predict`` payload fns, so it shares
devices, batching, and evolution machinery with concurrently-running
IMPRESS campaigns.

A copy of the JAX package's ``repro.core.multi_objective`` (free of JAX
there too), with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.api import Decision, DesignProtocol, revive_design_meta
from repro_torch.core.pipeline import Pipeline, ResourceRequest, Task
from repro_torch.core.protocol import fitness


@dataclass(frozen=True)
class MultiObjectiveConfig:
    n_candidates: int = 6
    n_cycles: int = 3          # accepted designs per trajectory
    max_declines: int = 6      # dominated candidates tolerated per cycle
    gen_devices: int = 1
    predict_devices: int = 1
    temperature: float = 1.0
    seed: int = 0


def _objectives(metrics: Dict[str, float]) -> List[float]:
    """Metrics -> maximize-all objective vector (pAE negated)."""
    return [float(metrics["plddt"]), float(metrics["ptm"]),
            -float(metrics["pae"])]


def dominates(a, b) -> bool:
    """True if objective vector ``a`` Pareto-dominates ``b``: at least as
    good everywhere, strictly better somewhere."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool((a >= b).all() and (a > b).any())


class MultiObjectiveProtocol(DesignProtocol):
    """Pure decision logic, fully unit-testable — see module docstring."""

    def __init__(self, cfg: MultiObjectiveConfig):
        self.cfg = cfg
        self.handlers = {
            "generate": self._on_generate,
            "predict": self._on_predict,
        }

    # -- task factories ----------------------------------------------------

    def new_pipeline(self, name: str, backbone: np.ndarray,
                     target: np.ndarray, receptor_len: int,
                     peptide_tokens: Optional[np.ndarray] = None,
                     **kwargs) -> Pipeline:
        if peptide_tokens is None:
            peptide_tokens = np.arange(1, 7, dtype=np.int32)
        return Pipeline(name=name, meta={
            "backbone": np.asarray(backbone, np.float32),
            "target": np.asarray(target, np.float32),
            "peptide_tokens": np.asarray(peptide_tokens, np.int32),
            "receptor_len": int(receptor_len),
            "candidates": None,      # (seqs (n,L), lls (n,)) sorted by LL
            "cand_idx": 0,
            "declines": 0,
            "front": [],             # accepted objective vectors (JSON-able)
            "trajectories": 0,
            "gen_version": 0,
        })

    def first_task(self, pl: Pipeline) -> Task:
        c = self.cfg
        return Task(kind="generate", pipeline_id=pl.uid, payload={
            "backbone": pl.meta["backbone"],
            "n": c.n_candidates,
            "length": pl.meta["receptor_len"],
            "temperature": c.temperature,
            "seed": c.seed + 1000 * pl.uid + pl.cycle,
        }, resources=ResourceRequest(n_devices=c.gen_devices))

    def _predict_task(self, pl: Pipeline) -> Task:
        seqs, _ = pl.meta["candidates"]
        i = pl.meta["cand_idx"]
        complex_seq = np.concatenate(
            [np.asarray(seqs[i], np.int32), pl.meta["peptide_tokens"]])
        return Task(kind="predict", pipeline_id=pl.uid, payload={
            "sequence": complex_seq,
            "target": pl.meta["target"],
            "receptor_len": pl.meta["receptor_len"],
        }, resources=ResourceRequest(n_devices=self.cfg.predict_devices))

    # -- completion handlers ----------------------------------------------

    def _on_generate(self, pl: Pipeline, result: Any) -> Decision:
        if isinstance(result, dict):
            pl.meta["gen_version"] = int(result.get("gen_version", 0))
            result = (result["seqs"], result["lls"])
        seqs, lls = result
        order = np.argsort(-np.asarray(lls))
        pl.meta["candidates"] = (np.asarray(seqs)[order],
                                 np.asarray(lls)[order])
        pl.meta["cand_idx"] = 0
        pl.meta["declines"] = 0
        return Decision(tasks=[self._predict_task(pl)])

    def _on_predict(self, pl: Pipeline, metrics: Dict[str, float]
                    ) -> Decision:
        c = self.cfg
        pl.meta["trajectories"] += 1
        obj = _objectives(metrics)
        if any(dominates(prior, obj) for prior in pl.meta["front"]):
            pl.meta["declines"] += 1
            pl.meta["cand_idx"] += 1
            seqs, _ = pl.meta["candidates"]
            if (pl.meta["declines"] <= c.max_declines
                    and pl.meta["cand_idx"] < len(seqs)):
                return Decision(tasks=[self._predict_task(pl)],
                                events=[{"event": "reselect",
                                         "cycle": pl.cycle}])
            pl.active = False
            return Decision(events=[{"event": "pruned", "cycle": pl.cycle}])

        # non-dominated: the front grows and the cycle advances
        seqs, _ = pl.meta["candidates"]
        chosen = seqs[pl.meta["cand_idx"]]
        pl.meta["front"].append(obj)
        pl.history.append(dict(
            metrics, fitness=fitness(metrics), cycle=pl.cycle,
            cand_idx=pl.meta["cand_idx"],
            sequence=np.asarray(chosen).tolist(),
            objectives=obj,
            gen_version=int(pl.meta.get("gen_version", 0))))
        pl.cycle += 1
        d = Decision(accepted_design=pl.history[-1])
        if pl.cycle >= c.n_cycles:
            pl.active = False
            d.events = [{"event": "completed", "cycle": pl.cycle - 1}]
        else:
            d.events = [{"event": "accepted", "cycle": pl.cycle - 1}]
            d.tasks = [self.first_task(pl)]
        return d

    # -- checkpoint hooks --------------------------------------------------

    def revive_meta(self, meta: dict) -> dict:
        return revive_design_meta(meta)
