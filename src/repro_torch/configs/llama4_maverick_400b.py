"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, MoE interleaved
every other layer + shared expert (~400B total / ~17B active).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] Copied from
``repro.configs.llama4_maverick_400b``.

48L, d_model=5120, 40H (GQA kv=8, head_dim 128), expert d_ff=8192,
vocab=202048. QK-norm, RoPE theta 5e5. Weights in bf16, the only config
that keeps them so (the router stays fp32).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        segments=((("attn", "moe"), 24),),
        moe_experts=128, moe_top_k=1, moe_d_ff=8192,
        moe_capacity_factor=1.25, moe_shared_expert=True,
        qk_norm=True, rope_theta=500000.0,
        param_dtype="bfloat16",
        attn_impl="xla_chunked",
        fsdp=True, sequence_parallel=True, remat="full", ce_chunks=16,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, segments=((("attn", "moe"), 2),),
        moe_experts=8, moe_top_k=1, moe_d_ff=128,
        param_dtype="float32", fsdp=False, sequence_parallel=False,
        remat="none")
