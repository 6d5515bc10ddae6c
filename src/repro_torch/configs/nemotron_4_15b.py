"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP.
[arXiv:2402.16819; unverified] Copied from
``repro.configs.nemotron_4_15b``.

32L, d_model=6144, 48H (GQA kv=8, head_dim 128), d_ff=24576, vocab=256000.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=256000,
        mlp_type="relu2", norm_type="layernorm",
        rope_theta=10000.0,
        fsdp=True, sequence_parallel=True, remat="full", ce_chunks=16,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, segments=(), fsdp=False)
