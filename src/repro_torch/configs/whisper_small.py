"""whisper-small [audio] — enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified] Copied from
``repro.configs.whisper_small``.

12L(enc)+12L(dec), d_model=768, 12H (GQA kv=12), d_ff=3072, vocab=51865.
Frontend: the log-mel conv stem is a STUB — the batch's ``"frames"``
supplies precomputed frame embeddings (B, 1500, 768). Whisper's learned
absolute positions are replaced by RoPE, as in the reference.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=51865,
        segments=((("dec_attn",), 12),),
        encoder_segments=((("enc_attn",), 12),),
        frontend="audio_frames", frontend_seq=1500,
        norm_type="layernorm", mlp_type="gelu", tie_embeddings=True,
        fsdp=False, remat="full", ce_chunks=4, train_microbatches=4,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        segments=((("dec_attn",), 2),), encoder_segments=((("enc_attn",), 2),),
        frontend_seq=8)
