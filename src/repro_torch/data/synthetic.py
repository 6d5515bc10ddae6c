"""Synthetic data pipeline.

Deterministic (seed, step, host)-keyed batches so every data-parallel host
generates exactly its shard without coordination — the same contract a real
sharded data pipeline satisfies. Token streams follow a Markov order-1
structure so the LM loss actually decreases during training runs.

Also provides the PDZ-like protein design task sampler used by the IMPRESS
protocol (backbone features + target peptide descriptors).

A port of the JAX package's ``repro.data.synthetic``. ``PDZ_NAMES`` and
``protein_design_tasks`` are copies (numpy only there too). ``lm_batch``
draws ``base``, ``noise`` and the frontend stubs from a CPU
``torch.Generator`` seeded from ``(seed, step, host)`` (a host-side data
pipeline, as the reference's is; the training loop moves each batch to its
device). JAX's threefry bits are not reproduced, so the same key gives
other tokens than the reference's; the arithmetic after the draws,
``lm_tokens``, is the reference's: int32 with its wrap-around, and a floor
modulo into ``[0, vocab)``.
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's multiplier, reduced mod the vocabulary in lm_tokens
_MULT = 6364136223846793005


def _wrap32(x):
    """An integer (or int64 tensor) taken mod 2**32 into int32's range."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def lm_tokens(base, noise, vocab_size):
    """The reference's token stream from its two draws: ``base`` (B, 1) and
    ``noise`` (B, S + 1) integer tensors give
    ``(base * mult ** (i % 7) + cumsum(noise)) mod V`` over positions i,
    with ``mult = 6364136223846793005 mod V``, computed as ``jnp.int32``
    computes it: every product and sum wraps mod 2**32, and the last
    ``mod V`` is a floor modulo, so wrapped negatives land in [0, V).
    Returns (B, S + 1) int32."""
    V = int(vocab_size)
    mult = _MULT % V
    powers = torch.tensor([_wrap32(mult ** e) for e in range(7)],
                          dtype=torch.int64)
    idx = torch.arange(noise.shape[1]) % 7
    # int64 holds a product of two int32s exactly; wrap once at the end
    # (mod 2**32 commutes with the products and sums)
    x = base.long() * powers[idx][None, :] + torch.cumsum(noise.long(), 1)
    return torch.remainder(_wrap32(x), V).to(torch.int32)


def lm_batch(cfg, batch_size, seq_len, *, seed=0, step=0, host=0, n_hosts=1):
    """One batch dict for this host's shard: {"inputs","targets"} (int32,
    targets the inputs shifted by one) and frontend stub embeddings (fp32)
    where the arch needs them, as CPU tensors."""
    assert batch_size % n_hosts == 0
    local = batch_size // n_hosts
    key = np.random.SeedSequence((int(seed), int(step), int(host)))
    gen = torch.Generator().manual_seed(int(key.generate_state(1)[0]))
    V = cfg.vocab_size
    base = torch.randint(0, V, (local, 1), generator=gen)
    noise = torch.randint(0, max(V // 64, 2), (local, seq_len + 1),
                          generator=gen)
    toks = lm_tokens(base, noise, V)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend in ("vision_patches", "audio_frames"):
        stub = 0.02 * torch.randn(local, cfg.frontend_seq, cfg.d_model,
                                  generator=gen)
        batch["patches" if cfg.frontend == "vision_patches"
              else "frames"] = stub
    return batch


def make_batch_iterator(cfg, batch_size, seq_len, *, seed=0, host=0,
                        n_hosts=1, start_step=0):
    step = start_step
    while True:
        yield lm_batch(cfg, batch_size, seq_len, seed=seed, step=step,
                       host=host, n_hosts=n_hosts)
        step += 1


# ---------------------------------------------------------------------------
# protein design tasks (IMPRESS payload)
# ---------------------------------------------------------------------------

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
