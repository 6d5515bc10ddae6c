from repro_torch.optim.optimizers import (OptConfig, adamw_update,
                                          clip_by_global_norm, global_norm,
                                          init_opt_state)
from repro_torch.optim.schedules import make_schedule
from repro_torch.optim.train_step import make_train_step

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "global_norm",
           "clip_by_global_norm", "make_schedule", "make_train_step"]
