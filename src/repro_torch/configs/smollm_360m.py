"""smollm-360m [dense] — llama-arch small.
[hf:HuggingFaceTB/SmolLM-360M; hf] Copied from
``repro.configs.smollm_360m``.

32L, d_model=960, 15H (GQA kv=5, head_dim 64), d_ff=2560, vocab=49152.
15 heads do not divide the 16-way model axis -> attention params replicate
on `model`; the FFN (2560 = 16*160) carries the tensor parallelism.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
        d_ff=2560, vocab_size=49152,
        tie_embeddings=True,
        fsdp=False, sequence_parallel=True, remat="full", ce_chunks=4,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
        d_ff=128, vocab_size=256, segments=())
