"""Campaign API: the pluggable protocol interface and typed task routing.

The paper's middleware value proposition is that protocols are swappable
workloads on shared adaptive infrastructure (IMPRESS runs IM-RP and CONT-V
as *two protocols, one middleware*).  This module is the contract that makes
that true in code: a ``DesignProtocol`` is any object that can

  1. bootstrap pipelines (``new_pipeline`` / ``first_task`` — the task
     factories), and
  2. route task completions through a **typed handler registry**
     (``handlers = {task_kind: callback}``), each callback returning a
     ``Decision``.

The coordinator (``core/coordinator.py``) never inspects task kinds itself:
it looks the kind up in the owning protocol's ``handlers`` mapping and acts
on the returned ``Decision`` — so a new protocol (binder-style, multi-
objective, …) plugs into an unmodified coordinator, and several protocols
can run concurrently on one executor (each pipeline carries a protocol
binding).

Checkpointing hooks (``pipeline_state`` / ``restore_pipeline`` /
``state_dict`` / ``load_state_dict``) let the coordinator serialize a
mixed-protocol campaign without knowing any protocol's meta layout.

``ImpressProtocol`` (protocol.py) and ``MultiObjectiveProtocol``
(multi_objective.py) are the in-tree implementations; the declarative
facade that wires everything is ``repro.session.ImpressSession``.

A copy of the JAX package's ``repro.core.api`` (free of JAX there too),
with its imports rewritten to ``repro_torch``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.pipeline import Pipeline, Task


@dataclass
class Decision:
    """The typed outcome of routing one task completion to a protocol.

    tasks            follow-up tasks to submit for the pipeline
    events           protocol-level events ``[{"event": str, "cycle": int}]``
                     — the coordinator stamps time/pipeline/provenance
    spawn            optional sub-pipeline proposal (opaque to the
                     coordinator; handed back to ``spawn_pipeline`` once
                     idle resources exist)
    accepted_design  optional design record (a pipeline history row) to
                     feed the model-evolution replay buffer — protocols
                     declare what is training data, the coordinator no
                     longer guesses from event names
    """
    tasks: List[Task] = field(default_factory=list)
    events: List[dict] = field(default_factory=list)
    spawn: Optional[dict] = None
    accepted_design: Optional[dict] = None


# A completion handler: (pipeline, task.result) -> Decision.  Handlers may
# also return a bare list of tasks; the coordinator normalizes it.
Handler = Callable[[Pipeline, Any], Decision]


def _jsonable(v):
    """Meta values -> JSON-serializable form (ndarray -> list, tuple of
    arrays -> list of lists)."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, tuple):
        return [np.asarray(x).tolist() for x in v]
    return v


class DesignProtocol(ABC):
    """Abstract interface every campaign protocol implements.

    Required:
      handlers       mapping ``{task_kind: Handler}`` — the typed routing
                     registry the coordinator dispatches completions through
      new_pipeline   build a design pipeline for one starting structure
      first_task     the pipeline's bootstrap task (a task factory)

    Optional (defaults are no-ops suitable for spawn-free protocols):
      can_spawn / spawn_pipeline     sub-pipeline support
      state_dict / load_state_dict   protocol-level checkpoint state
      pipeline_state / revive_meta   per-pipeline (de)serialization
    """

    # annotation only — every implementation must assign its OWN mapping
    # (typically in __init__); a class-level default dict would be shared
    # mutable state across all protocols
    handlers: Dict[str, Handler]

    # -- task factories ----------------------------------------------------

    @abstractmethod
    def new_pipeline(self, name: str, backbone: np.ndarray,
                     target: np.ndarray, receptor_len: int,
                     peptide_tokens: Optional[np.ndarray] = None,
                     **kwargs) -> Pipeline:
        """Bootstrap a pipeline for one starting structure."""

    @abstractmethod
    def first_task(self, pl: Pipeline) -> Task:
        """The task that starts (or resumes) ``pl``."""

    def task_kinds(self) -> tuple:
        """The task kinds this protocol routes — used by the session facade
        to validate that the executor has a payload fn for each."""
        return tuple(self.handlers)

    def stage_specs(self) -> tuple:
        """The protocol's stage table (``core.stages.StageSpec`` entries).
        Staged protocols stamp their tasks with stage labels / priority
        bands / param namespaces; the session facade reads this table to
        create the param-set namespaces, register per-stage coalesce
        rules, and push band shares into the task queue. Default: the
        protocol is unstaged."""
        return ()

    # -- sub-pipelines -----------------------------------------------------

    def can_spawn(self) -> bool:
        """Whether a parked spawn proposal is still admissible (e.g. a
        sub-pipeline cap has not been reached)."""
        return False

    def spawn_pipeline(self, spawn: dict) -> Optional[Pipeline]:
        """Materialize a ``Decision.spawn`` proposal into a pipeline (and
        account for it). None = the proposal is dropped."""
        return None

    # -- checkpoint hooks --------------------------------------------------

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass

    def pipeline_state(self, pl: Pipeline) -> dict:
        """JSON-serializable snapshot of one pipeline."""
        return {
            "name": pl.name, "uid": pl.uid, "parent": pl.parent,
            "cycle": pl.cycle, "active": pl.active, "history": pl.history,
            "meta": {k: _jsonable(v) for k, v in pl.meta.items()},
        }

    def revive_meta(self, meta: dict) -> dict:
        """Hook for ``restore_pipeline``: rebuild ``meta`` after a JSON
        round-trip. The generic form keeps plain JSON types; protocols
        whose task builders need arrays override this (the in-tree ones
        use ``revive_design_meta``)."""
        return dict(meta)

    def restore_pipeline(self, rec: dict) -> Pipeline:
        """Rebuild a pipeline from ``pipeline_state`` output."""
        pl = Pipeline(name=rec["name"], parent=rec["parent"],
                      meta=self.revive_meta(rec["meta"]))
        pl.cycle = rec["cycle"]
        pl.active = rec["active"]
        pl.history = rec["history"]
        return pl


def revive_design_meta(meta: dict) -> dict:
    """Rebuild the array-typed entries of a design-protocol pipeline meta
    after a JSON round-trip: backbone/target features, peptide tokens, and
    the ranked ``(seqs, lls)`` candidate tuple. Shared by the in-tree
    protocols' ``restore_pipeline`` overrides."""
    meta = dict(meta)
    meta["backbone"] = np.asarray(meta["backbone"], np.float32)
    meta["target"] = np.asarray(meta["target"], np.float32)
    if meta.get("peptide_tokens") is not None:
        meta["peptide_tokens"] = np.asarray(meta["peptide_tokens"], np.int32)
    if meta.get("candidates"):
        seqs, lls = meta["candidates"]
        meta["candidates"] = (np.asarray(seqs, np.int32),
                              np.asarray(lls, np.float32))
    return meta
