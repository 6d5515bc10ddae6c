"""The PDZ-like protein design task sampler used by the IMPRESS protocol
(backbone features + target peptide descriptors).

A copy of ``PDZ_NAMES`` and ``protein_design_tasks`` from the JAX package's
``repro.data.synthetic`` (numpy only there too); its LM batches are not
ported yet.
"""

from __future__ import annotations

import numpy as np

PDZ_NAMES = ("NHERF3", "HTRA1", "SCRIB", "SHANK1")


def protein_design_tasks(n_tasks, *, receptor_len=48, peptide_len=10,
                         feat_dim=16, seed=0):
    """Sample n PDZ-like design tasks. Each task: a backbone feature tensor
    (receptor_len+peptide_len, feat_dim) standing in for the prepared
    PDZ-peptide complex structure, and a target descriptor (feat_dim,)
    (the alpha-synuclein C-terminus the paper designs binders for).

    ``receptor_len`` may be a sequence — one length per task, cycled — for
    mixed-length campaigns (the realistic case: every designable protein
    has a different length). An int keeps the seed draw sequence exactly.
    """
    rng = np.random.default_rng(seed)
    lens = (list(receptor_len) if isinstance(receptor_len, (tuple, list))
            else [receptor_len])
    tasks = []
    target = rng.normal(size=(feat_dim,)).astype(np.float32)
    # the fixed target peptide (alpha-synuclein C-terminus analogue)
    peptide_tokens = rng.integers(1, 21, size=(peptide_len,)).astype(np.int32)
    for i in range(n_tasks):
        name = PDZ_NAMES[i] if i < len(PDZ_NAMES) else f"PDZ{i:03d}"
        rl = int(lens[i % len(lens)])
        backbone = rng.normal(
            size=(rl + peptide_len, feat_dim)).astype(np.float32)
        tasks.append({
            "name": name,
            "backbone": backbone,
            "target": target + 0.1 * rng.normal(size=(feat_dim,)).astype(np.float32),
            "receptor_len": rl,
            "peptide_len": peptide_len,
            "peptide_tokens": peptide_tokens,
        })
    return tasks
