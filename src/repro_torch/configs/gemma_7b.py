"""Gemma 7B — GeGLU, head_dim=256, embed scaling [arXiv:2403.08295; hf].
28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000."""
from repro_torch.models.config import LayerKind, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", n_layers=28, d_model=3072,
        n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000,
        mlp="geglu",
        pattern=(LayerKind.ATTN,),
        rope_theta=10000.0,
        embed_scale=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                            head_dim=16, d_ff=128, vocab=199, remat="none")
