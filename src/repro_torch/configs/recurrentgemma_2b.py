"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427; hf]. Copied from ``repro.configs.recurrentgemma_2b``.

26L, d_model=2560, 10H (MQA kv=1, head_dim 256), d_ff=7680, vocab=256000.
Pattern: (recurrent, recurrent, local-attn) repeating; 26 = 8*3 + 2.
Local attention window 2048. GeGLU MLP, tied embeddings, emb scaling.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab_size=256000,
        segments=((("rglru", "rglru", "attn_local"), 8),
                  (("rglru", "rglru"), 1)),
        attn_window=2048, lru_width=2560, conv_width=4,
        mlp_type="geglu", tie_embeddings=True, emb_scale=True,
        rope_theta=10000.0,
        fsdp=True, remat="full", train_microbatches=4, ce_chunks=16,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=256, lru_width=64, attn_window=16,
        segments=((("rglru", "rglru", "attn_local"), 1),
                  (("rglru", "rglru"), 1)),
        fsdp=False)
