"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783; unverified] Copied from
``repro.configs.llama3_8b``.

32L, d_model=4096, 32H (GQA kv=8, head_dim 128), d_ff=14336, vocab=128256.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=128256,
        rope_theta=500000.0,
        fsdp=True, sequence_parallel=True, remat="full", ce_chunks=8,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, segments=(), fsdp=False)
