"""Fitness-weighted replay buffer of accepted designs.

The coordinator pushes every accepted design (the §V "HPC output becomes
training data" half of the bidirectional coupling) as a
(backbone, sequence, fitness, generator version) record. When full, the
lowest-fitness record is evicted, so the buffer concentrates on the best
designs seen so far. ``sample`` draws a fitness-weighted training batch in
the shape the ``finetune`` payload consumes.

The buffer is JSON-serializable (``state_dict``/``load_state_dict``) so it
rides along in the coordinator's checkpoint extra.

A copy of the JAX package's ``repro.learn.replay_buffer`` (free of JAX
there too).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._items: List[dict] = []
        self._lock = threading.Lock()
        self.total_added = 0
        self.total_evicted = 0

    def add(self, backbone, sequence, fitness: float, gen_version: int = 0):
        item = {
            "backbone": np.asarray(backbone, np.float32),
            "sequence": np.asarray(sequence, np.int32),
            "fitness": float(fitness),
            "gen_version": int(gen_version),
        }
        with self._lock:
            self._items.append(item)
            self.total_added += 1
            if len(self._items) > self.capacity:
                worst = min(range(len(self._items)),
                            key=lambda i: self._items[i]["fitness"])
                self._items.pop(worst)
                self.total_evicted += 1

    def __len__(self):
        with self._lock:
            return len(self._items)

    def _weights(self, items: List[dict]) -> np.ndarray:
        """Sampling/training weights: fitness shifted positive so the worst
        retained design still has a small non-zero mass."""
        f = np.array([it["fitness"] for it in items], np.float32)
        w = f - f.min() + 1e-3
        return w

    def sample(self, k: int, rng: Optional[np.random.Generator] = None
               ) -> Optional[dict]:
        """Fitness-weighted batch of up to ``k`` designs (without
        replacement). Designs are grouped by (sequence length, backbone
        shape) and the largest group is sampled, so the batch stacks.
        Returns {"backbones", "sequences", "weights", "gen_versions"} or
        None when the buffer is empty."""
        rng = rng or np.random.default_rng(0)
        with self._lock:
            items = list(self._items)
        if not items:
            return None
        by_shape: Dict[tuple, List[dict]] = {}
        for it in items:
            key = (it["sequence"].shape, it["backbone"].shape)
            by_shape.setdefault(key, []).append(it)
        group = max(by_shape.values(), key=len)
        k = min(int(k), len(group))
        w = self._weights(group)
        idx = rng.choice(len(group), size=k, replace=False, p=w / w.sum())
        picked = [group[i] for i in idx]
        return {
            "backbones": np.stack([p["backbone"] for p in picked]),
            "sequences": np.stack([p["sequence"] for p in picked]),
            "weights": self._weights(picked),
            "gen_versions": np.array([p["gen_version"] for p in picked],
                                     np.int32),
        }

    def stats(self) -> dict:
        with self._lock:
            items = list(self._items)
        by_version: Dict[int, int] = {}
        for it in items:
            by_version[it["gen_version"]] = \
                by_version.get(it["gen_version"], 0) + 1
        return {
            "size": len(items),
            "capacity": self.capacity,
            "added": self.total_added,
            "evicted": self.total_evicted,
            "mean_fitness": (float(np.mean([i["fitness"] for i in items]))
                             if items else None),
            "by_gen_version": by_version,
        }

    # -- checkpoint/restart -------------------------------------------------

    def state_dict(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "added": self.total_added,
                "evicted": self.total_evicted,
                "items": [{
                    "backbone": it["backbone"].tolist(),
                    "sequence": it["sequence"].tolist(),
                    "fitness": it["fitness"],
                    "gen_version": it["gen_version"],
                } for it in self._items],
            }

    def load_state_dict(self, state: dict):
        with self._lock:
            self.capacity = int(state["capacity"])
            self.total_added = int(state["added"])
            self.total_evicted = int(state["evicted"])
            self._items = [{
                "backbone": np.asarray(it["backbone"], np.float32),
                "sequence": np.asarray(it["sequence"], np.int32),
                "fitness": float(it["fitness"]),
                "gen_version": int(it["gen_version"]),
            } for it in state["items"]]
