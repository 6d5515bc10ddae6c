"""PyTorch/CUDA port of the IMPRESS reproduction (``src/repro``).

Laid out like the JAX package: ``configs/``, ``models/``, ``kernels/``,
``core/``, ``runtime/``, ``launch/``, each module beside its reference
counterpart.
Imports torch and numpy only, never jax or the reference package.

Numerics: parameters are fp32 and compute is ``cfg.compute_dtype`` (bf16 by
default). fp32 products must be full fp32 as in the reference, so TF32 is
switched off for matrix products and cuDNN alike.

Devices: entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (as the CPU tests do). A CUDA device that is asked for and
absent raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on, with a CUDA device's index made
    explicit; raises if it is a CUDA device and this process has none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
