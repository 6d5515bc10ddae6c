"""The IMPRESS protocol's scalar design quality (copy of
``repro.core.protocol.fitness``); the protocol's decision logic is ported
with the campaign engine."""

from __future__ import annotations

from typing import Dict


def fitness(metrics: Dict[str, float]) -> float:
    """Scalar design quality: pLDDT and pTM up, inter-chain pAE down."""
    return metrics["plddt"] / 100.0 + metrics["ptm"] - metrics["pae"] / 30.0
