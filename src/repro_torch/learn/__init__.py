# Model-evolution subsystem (paper §V): replay buffer of accepted designs
# (replay_buffer.py), versioned hot-swappable generator weights
# (param_store.py), and the preemptible opportunistic trainer service
# (trainer.py). The finetune payload fn itself lives with the other device
# payloads in repro_torch.core.payload (FinetunePayload).
from repro_torch.learn.param_store import ParamStore
from repro_torch.learn.replay_buffer import ReplayBuffer
from repro_torch.learn.trainer import EvolutionConfig, TrainerService

__all__ = ["ParamStore", "ReplayBuffer", "EvolutionConfig", "TrainerService"]
