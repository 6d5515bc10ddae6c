"""Config lookup for the two payload models this slice of the port runs."""

from __future__ import annotations

from repro_torch.configs import protein_impress as _pi

_FULL = {"progen-s": _pi.progen_config, "foldscore-s": _pi.foldscore_config}
_REDUCED = {"progen-s": _pi.progen_reduced,
            "foldscore-s": _pi.foldscore_reduced}


def get_config(arch_id: str):
    if arch_id not in _FULL:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_FULL)}")
    return _FULL[arch_id]()


def get_reduced(arch_id: str):
    if arch_id not in _REDUCED:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REDUCED)}")
    # large-scale memory knobs are irrelevant at smoke-test scale
    return _REDUCED[arch_id]().replace(ce_chunks=1, train_microbatches=1,
                                       sequence_parallel=False, remat="none")
