"""Nemotron-4 15B — dense GQA, squared-ReLU MLP [arXiv:2402.16819].
32L d_model=6144 48H (kv=8) d_ff=24576 vocab=256000."""
from repro_torch.models.config import LayerKind, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=256000,
        mlp="sq_relu",
        pattern=(LayerKind.ATTN,),
        rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                            head_dim=16, d_ff=192, vocab=251, remat="none")
