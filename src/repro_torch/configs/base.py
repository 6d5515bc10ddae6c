"""Model configuration dataclass (copy of ``repro.configs.base.ModelConfig``).

The layer stack is described by *segments*: ``(kinds, repeats)`` pairs,
where ``kinds`` is a tuple of layer-kind strings making up one repeating
block. The reference scans each segment over stacked parameters; the port
flattens the segments into one list of layers walked by a Python loop
(``layer_kinds``). The fields are the reference's, so a config converts
field by field; the port runs the ``attn``, ``attn_local``, ``rwkv`` and
``rglru`` kinds.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

Segment = Tuple[Tuple[str, ...], int]  # (block kinds, repeats)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    segments: Tuple[Segment, ...] = ()

    # --- attention ---
    attn_window: int = 0             # local-attention window (0 = n/a)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # fraction of head_dim that is rotated
    rope_style: str = "half"         # "half" (llama) | "interleaved" (chatglm)
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q/k

    # --- mlp ---
    mlp_type: str = "swiglu"         # swiglu | geglu | relu2 | gelu

    # --- moe ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_shared_expert: bool = False
    moe_impl: str = "capacity"
    moe_parallelism: str = "ep"

    # --- ssm / recurrent ---
    lru_width: int = 0               # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32

    # --- encoder / frontend ---
    encoder_segments: Tuple[Segment, ...] = ()
    frontend: str = ""               # "" | "audio_frames" | "vision_patches"
    frontend_seq: int = 0            # frames / patches supplied by the stub

    # --- norm / embedding ---
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    emb_scale: bool = False          # multiply token emb by sqrt(d_model)

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- distribution policy ---
    fsdp: bool = False
    sequence_parallel: bool = False
    remat: str = "none"
    scan_layers: bool = True
    train_microbatches: int = 1
    ce_chunks: int = 1

    # --- attention implementation (the reference's switch; the port always
    # runs its kernels on CUDA and their plain versions on the CPU) ---
    attn_impl: str = "xla"
    ssm_impl: str = "xla"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.segments:
            object.__setattr__(self, "segments", ((("attn",), self.n_layers),))
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        total = sum(len(k) * r for k, r in self.segments)
        if total != self.n_layers:
            raise ValueError(f"{self.name}: segments describe {total} "
                             f"layers, expected {self.n_layers}")

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128."""
        return 128 * math.ceil(self.vocab_size / 128)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Every layer's kind, in order: the segments flattened."""
        return tuple(k for kinds, reps in self.segments
                     for _ in range(reps) for k in kinds)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
