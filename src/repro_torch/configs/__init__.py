"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

Arch ids follow the assignment sheet; module names are the sanitized forms.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    reduced,
    supports_shape,
)

_ARCH_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-1b": "internvl2_1b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "qwen3-8b": "qwen3_8b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "granite-3-8b": "granite_3_8b",
    "minitron-8b": "minitron_8b",
    "whisper-medium": "whisper_medium",
    "jamba2-mini": "jamba2_mini",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = [
    "ModelConfig", "ParallelConfig", "ShapeConfig", "SHAPES",
    "get_config", "get_shape", "list_archs", "reduced", "supports_shape",
]
