"""Config lookup for the models the port runs: the payload models of the
design cycle (progen-s, foldscore-s and the foldscore-m multimer scorer of
the staged binder's fold stage) and the rwkv6-7b and recurrentgemma-2b
language models."""

from __future__ import annotations

from repro_torch.configs import protein_impress as _pi
from repro_torch.configs import recurrentgemma_2b as _rg
from repro_torch.configs import rwkv6_7b as _rwkv

_FULL = {"progen-s": _pi.progen_config, "foldscore-s": _pi.foldscore_config,
         "foldscore-m": _pi.foldscore_multimer_config,
         "rwkv6-7b": _rwkv.config, "recurrentgemma-2b": _rg.config}
_REDUCED = {"progen-s": _pi.progen_reduced,
            "foldscore-s": _pi.foldscore_reduced,
            "foldscore-m": _pi.foldscore_multimer_reduced,
            "rwkv6-7b": _rwkv.reduced, "recurrentgemma-2b": _rg.reduced}


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
