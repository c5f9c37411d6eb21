"""Assigned architecture configs. ``get_config(name)`` / ``get_smoke(name)``.

Copies of ``repro.configs`` with the import of ``ModelConfig`` from the
port's own ``models.config``."""

from __future__ import annotations

import importlib
from typing import Dict

ARCHS = [
    "rwkv6_7b", "nemotron_4_15b", "deepseek_67b", "gemma_7b", "gemma2_27b",
    "whisper_base", "mixtral_8x22b", "arctic_480b", "jamba_v0_1_52b",
    "internvl2_1b",
]

ALIASES = {
    "rwkv6-7b": "rwkv6_7b", "nemotron-4-15b": "nemotron_4_15b",
    "deepseek-67b": "deepseek_67b", "gemma-7b": "gemma_7b",
    "gemma2-27b": "gemma2_27b", "whisper-base": "whisper_base",
    "mixtral-8x22b": "mixtral_8x22b", "arctic-480b": "arctic_480b",
    "jamba-v0.1-52b": "jamba_v0_1_52b", "internvl2-1b": "internvl2_1b",
}


def _mod(name: str):
    name = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _mod(name).config()


def get_smoke(name: str):
    return _mod(name).smoke_config()


# shapes assigned to the LM family (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, step="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, step="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, step="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, step="decode"),
}

# archs that run long_500k (sub-quadratic attention); pure full-attention
# archs skip it (DESIGN.md §4)
LONG_OK = {"rwkv6_7b", "mixtral_8x22b", "jamba_v0_1_52b"}


def cells():
    """All (arch, shape) dry-run cells, with skips annotated."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            skip = None
            if s == "long_500k" and a not in LONG_OK:
                skip = "full quadratic attention at 500k (DESIGN.md §4)"
            out.append((a, s, skip))
    return out
