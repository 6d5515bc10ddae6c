"""Config lookup for the models the port runs: the payload models of the
design cycle (progen-s, foldscore-s and the foldscore-m multimer scorer of
the staged binder's fold stage) and the reference's ten language models
(``ARCH_IDS``, in the reference's order)."""

from __future__ import annotations

from repro_torch.configs import chatglm3_6b as _glm
from repro_torch.configs import llama3_8b as _llama
from repro_torch.configs import llama4_maverick_400b as _llama4
from repro_torch.configs import llava_next_34b as _llava
from repro_torch.configs import nemotron_4_15b as _nemo
from repro_torch.configs import protein_impress as _pi
from repro_torch.configs import qwen3_moe_30b as _qwen3
from repro_torch.configs import recurrentgemma_2b as _rg
from repro_torch.configs import rwkv6_7b as _rwkv
from repro_torch.configs import smollm_360m as _smol
from repro_torch.configs import whisper_small as _whisper

_LMS = {"whisper-small": _whisper, "recurrentgemma-2b": _rg,
        "rwkv6-7b": _rwkv, "nemotron-4-15b": _nemo, "smollm-360m": _smol,
        "chatglm3-6b": _glm, "llama3-8b": _llama,
        "llama4-maverick-400b-a17b": _llama4, "qwen3-moe-30b-a3b": _qwen3,
        "llava-next-34b": _llava}
_FULL = {"progen-s": _pi.progen_config, "foldscore-s": _pi.foldscore_config,
         "foldscore-m": _pi.foldscore_multimer_config,
         **{k: m.config for k, m in _LMS.items()}}
_REDUCED = {"progen-s": _pi.progen_reduced,
            "foldscore-s": _pi.foldscore_reduced,
            "foldscore-m": _pi.foldscore_multimer_reduced,
            **{k: m.reduced for k, m in _LMS.items()}}
# the reference's language models in its registry's order
ARCH_IDS = tuple(_LMS)


def _check(arch_id):
    if arch_id not in _FULL:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_FULL)}")


def get_config(arch_id: str):
    _check(arch_id)
    return _FULL[arch_id]()


def get_reduced(arch_id: str):
    _check(arch_id)
    # large-scale memory knobs are irrelevant at smoke-test scale
    return _REDUCED[arch_id]().replace(ce_chunks=1, train_microbatches=1,
                                       sequence_parallel=False, remat="none")
