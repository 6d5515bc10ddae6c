"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, QK-norm.
[hf:Qwen/Qwen3-30B-A3B; hf] Copied from ``repro.configs.qwen3_moe_30b``.

48L, d_model=2048, 32H (GQA kv=4, explicit head_dim=128), expert d_ff=768,
vocab=151936. Every layer is MoE; no shared expert.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=6144, vocab_size=151936,
        segments=((("moe",), 48),),
        moe_experts=128, moe_top_k=8, moe_d_ff=768,
        moe_capacity_factor=1.25, moe_parallelism="fsdp",
        qk_norm=True, rope_theta=1000000.0,
        fsdp=True, sequence_parallel=True, remat="full", ce_chunks=8,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, segments=((("moe",), 2),),
        moe_experts=8, moe_top_k=2, moe_d_ff=32, fsdp=False)
