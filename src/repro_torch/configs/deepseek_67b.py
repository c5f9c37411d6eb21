"""DeepSeek 67B — llama-arch dense GQA [arXiv:2401.02954; hf].
95L d_model=8192 64H (kv=8) d_ff=22016 vocab=102400."""
from repro_torch.models.config import LayerKind, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", n_layers=95, d_model=8192,
        n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab=102400,
        mlp="swiglu",
        pattern=(LayerKind.ATTN,),
        rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=160, vocab=211, remat="none")
