"""Architecture registry: --arch <id> resolution."""

from . import (granite_8b, grok1_314b, mamba2_2_7b, phi3_mini_3_8b,
               qwen2_vl_72b, qwen3_8b, qwen3_moe_235b_a22b,
               recurrentgemma_9b, whisper_small, yi_6b)
from .base import SHAPES, ArchConfig, ShapeSpec, runnable_shapes

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    qwen3_8b, yi_6b, granite_8b, phi3_mini_3_8b, whisper_small,
    recurrentgemma_9b, qwen3_moe_235b_a22b, grok1_314b, mamba2_2_7b,
    qwen2_vl_72b,
)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
