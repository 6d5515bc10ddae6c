"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]. Copied from ``repro.configs.rwkv6_7b``.

32L, d_model=4096 (64 heads x 64), d_ff=14336, vocab=65536. No RoPE.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab_size=65536,
        segments=((("rwkv",), 32),),
        rwkv_head_dim=64, rwkv_chunk=64,
        fsdp=True, remat="full", train_microbatches=8, ce_chunks=4,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, rwkv_head_dim=16,
        segments=((("rwkv",), 2),), fsdp=False)
