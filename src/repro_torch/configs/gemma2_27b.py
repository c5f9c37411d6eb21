"""Gemma-2 27B — alternating local(4096)/global attention, logit
softcaps [arXiv:2408.00118; hf]. 46L d_model=4608 32H (kv=16)
d_ff=36864 vocab=256000."""
from repro_torch.models.config import LayerKind, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", n_layers=46, d_model=4608,
        n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=36864, vocab=256000,
        mlp="geglu",
        pattern=(LayerKind.ATTN_LOCAL, LayerKind.ATTN),  # local/global
        window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        embed_scale=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128, vocab=199, window=8,
                            remat="none")
