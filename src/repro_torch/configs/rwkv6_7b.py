"""RWKV-6 'Finch' 7B — attention-free, data-dependent decay
[arXiv:2404.05892; hf]. 32L d_model=4096 d_ff=14336 vocab=65536."""
from repro_torch.models.config import LayerKind, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", n_layers=32, d_model=4096,
        n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab=65536,
        mlp="sq_relu",                     # rwkv channel-mix: relu^2
        pattern=(LayerKind.RWKV,),
        rwkv_head_dim=64,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                            head_dim=32, d_ff=128, vocab=97,
                            rwkv_head_dim=32, remat="none")
