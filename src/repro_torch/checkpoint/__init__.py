from repro_torch.checkpoint.io import (CheckpointCorruptError, load_pytree,
                                       save_pytree, verify_checkpoint)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["save_pytree", "load_pytree", "verify_checkpoint",
           "CheckpointCorruptError", "CheckpointManager"]
