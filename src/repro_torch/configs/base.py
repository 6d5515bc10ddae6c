"""Model configuration dataclass (copy of ``repro.configs.base.ModelConfig``).

The layer stack is described by *segments*: ``(kinds, repeats)`` pairs,
where ``kinds`` is a tuple of layer-kind strings making up one repeating
block. The reference scans each segment over stacked parameters; the port
flattens the segments into one list of layers walked by a Python loop
(``layer_kinds``; the encoder's, ``encoder_segments``, likewise
``encoder_kinds``). The fields are the reference's, so a config converts
field by field; the port runs every kind: ``attn``, ``attn_local``,
``rwkv``, ``rglru``, ``enc_attn``, ``dec_attn``, ``moe`` and
``attn_local_moe``.
``param_count`` and ``active_param_count`` are the reference's.
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

    @property
    def encoder_kinds(self) -> Tuple[str, ...]:
        """Every encoder layer's kind, in order (empty without an
        encoder)."""
        return tuple(k for kinds, reps in self.encoder_segments
                     for _ in range(reps) for k in kinds)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + per-layer), the
        reference's reckoning."""
        d = self.d_model
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_kind = {}
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp_mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        mlp = mlp_mult * d * self.d_ff
        moe = self.moe_experts * (3 * d * self.moe_d_ff) + d * self.moe_experts
        if self.moe_shared_expert:
            moe += 3 * d * self.d_ff
        per_kind["attn"] = attn + mlp
        per_kind["attn_local"] = attn + mlp
        per_kind["enc_attn"] = attn + mlp
        per_kind["dec_attn"] = 2 * attn + mlp
        per_kind["moe"] = attn + moe
        per_kind["attn_local_moe"] = attn + moe
        per_kind["rglru"] = (2 * d * self.lru_width + self.lru_width * d
                             + self.conv_width * self.lru_width
                             + 2 * self.lru_width + mlp)
        per_kind["rwkv"] = (5 * d * d + d * d        # r,k,v,g,o
                            + 6 * 32 * d * 2         # ddlerp loras
                            + d * 64 * 2 + 2 * d     # decay lora, u
                            + 2 * d * self.d_ff + d * d)  # channel mix
        total = emb
        for kinds, reps in self.segments + self.encoder_segments:
            for k in kinds:
                total += per_kind[k] * reps
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts instead of all)."""
        if self.moe_experts == 0:
            return self.param_count()
        full_moe = self.moe_experts * 3 * self.d_model * self.moe_d_ff
        active_moe = self.moe_top_k * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = sum(
            sum(1 for k in kinds if k in ("moe", "attn_local_moe")) * reps
            for kinds, reps in self.segments)
        return self.param_count() - n_moe_layers * (full_moe - active_moe)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell (a copy of the reference's)."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if skipped.

    ``long_500k`` needs sub-quadratic sequence mixing: it runs only for
    ssm/hybrid families (constant-size or windowed state); pure
    full-attention archs skip it.
    """
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k skipped: full-attention arch (quadratic prefill, unbounded KV)"
    return True, ""
