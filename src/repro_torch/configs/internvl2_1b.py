"""InternVL2 1B — InternViT stub frontend + InternLM2 backbone
[arXiv:2404.16821; hf]. 24L d_model=896 14H (kv=2) d_ff=4864
vocab=151655. The ViT is a STUB: input_specs provide precomputed patch
embeddings (n_image_tokens x d_model) per the assignment."""
from repro_torch.models.config import LayerKind, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151655,
        mlp="swiglu",
        pattern=(LayerKind.ATTN,),
        n_image_tokens=256,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
                            head_dim=8, d_ff=112, vocab=131,
                            n_image_tokens=8, remat="none")
