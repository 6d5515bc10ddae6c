"""Paper payload models: ProGen (ProteinMPNN analogue, structure-conditioned
sequence model) and FoldScore (AlphaFold analogue, confidence scorer).
Copied from ``repro.configs.protein_impress``."""

from repro_torch.configs.base import ModelConfig

AA_VOCAB = 32  # 20 amino acids + specials, padded


def progen_config() -> ModelConfig:
    return ModelConfig(
        name="progen-s", family="dense",
        n_layers=6, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=1024, vocab_size=AA_VOCAB,
        frontend="vision_patches",   # structure embeddings prepended as prefix
        frontend_seq=64,
        fsdp=False,
    )


def progen_reduced() -> ModelConfig:
    return progen_config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, segments=(), frontend_seq=8)


def foldscore_config() -> ModelConfig:
    return ModelConfig(
        name="foldscore-s", family="dense",
        n_layers=8, d_model=256, n_heads=8, n_kv_heads=8, head_dim=32,
        d_ff=1024, vocab_size=AA_VOCAB,
        fsdp=False,
    )


def foldscore_reduced() -> ModelConfig:
    return foldscore_config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, segments=())


def foldscore_multimer_config() -> ModelConfig:
    """Heavier complex-scoring variant (the AlphaFold-Multimer analogue):
    staged binder protocols use it as the fold stage's second param set —
    a genuinely distinct model from the per-chain ``foldscore-s`` scorer,
    so the stage table exercises two configs, not just two inits.

    ``segments=()`` is the port's own: the base config materializes an
    8-layer plan in ``__post_init__``, which the reference's copy keeps, so
    its full-width foldscore-m raises on construction (ROADMAP Queue 3)."""
    return foldscore_config().replace(name="foldscore-m", n_layers=12,
                                      d_ff=1536, segments=())


def foldscore_multimer_reduced() -> ModelConfig:
    # segments re-cleared: the reduced base materializes a 2-layer plan in
    # __post_init__, which would contradict the deeper layer count
    return foldscore_reduced().replace(name="foldscore-m", n_layers=3,
                                       segments=())
