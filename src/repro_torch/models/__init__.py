"""The LM side (PyTorch twin of ``repro.models``): configs, layers, the
RWKV-6 mixer and the stacked-block transformer. Its serving half is
ported (forward, prefill, the cache decode step); MoE, Mamba, the
encoder-decoder path, the sharding rules and training are ROADMAP.md
queue 1 item 8's later part."""

from .config import ModelConfig, MoECfg, LayerKind  # noqa: F401
