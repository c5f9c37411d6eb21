"""Whisper base — enc-dec, conv frontend STUB (precomputed frame
embeddings per the assignment) [arXiv:2212.04356]. 6L d_model=512 8H
(kv=8) d_ff=2048 vocab=51865."""
from repro_torch.models.config import LayerKind, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab=51865,
        mlp="gelu",
        pattern=(LayerKind.ATTN,),
        enc_layers=6, cross_attention=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                            head_dim=16, d_ff=128, vocab=173, enc_layers=2,
                            remat="none")
