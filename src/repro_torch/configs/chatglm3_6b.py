"""chatglm3-6b [dense] — 2d (partial, interleaved) RoPE, GQA kv=2.
[arXiv:2406.12793; hf] Copied from
``repro.configs.chatglm3_6b``.

28L, d_model=4096, 32H (GQA kv=2, head_dim 128), d_ff=13696, vocab=65024.
RoPE applied to half the head dim in interleaved (pairwise) style.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=65024,
        rope_fraction=0.5, rope_style="interleaved",
        fsdp=True, sequence_parallel=True, remat="full", ce_chunks=4,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, segments=(), fsdp=False)
