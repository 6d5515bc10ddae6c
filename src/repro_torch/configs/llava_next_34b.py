"""llava-next-34b [vlm] — anyres tiling frontend stubbed; Yi-34B backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] Copied from
``repro.configs.llava_next_34b``.

60L, d_model=7168, 56H (GQA kv=8, head_dim 128), d_ff=20480, vocab=64000.
Frontend: the vision tower + anyres tiling is a STUB — the batch's
``"patches"`` supplies projected patch embeddings (B, 576, 7168),
prepended to tokens.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab_size=64000,
        frontend="vision_patches", frontend_seq=576,
        rope_theta=5000000.0,
        fsdp=True, sequence_parallel=True, remat="full", ce_chunks=4,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, segments=(), frontend_seq=8,
        fsdp=False, remat="none")
