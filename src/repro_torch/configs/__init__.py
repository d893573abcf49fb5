"""repro_torch.configs — one module per assigned architecture (+ smoke variants)."""
from . import (
    dbrx_132b,
    glm4_9b,
    granite_3_8b,
    jamba_v0_1_52b,
    llama3_405b,
    mamba2_2_7b,
    minicpm_2b,
    mixtral_8x22b,
    qwen2_vl_72b,
    whisper_tiny,
)
from .base import ArchConfig, SHAPES, ShapeCell, cells_for, smoke_cell

_MODULES = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "granite-3-8b": granite_3_8b,
    "llama3-405b": llama3_405b,
    "minicpm-2b": minicpm_2b,
    "glm4-9b": glm4_9b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "whisper-tiny": whisper_tiny,
    "mixtral-8x22b": mixtral_8x22b,
    "dbrx-132b": dbrx_132b,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCHS = list(_MODULES)


def get(name: str, smoke: bool = False) -> ArchConfig:
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeCell", "cells_for", "get",
           "smoke_cell"]
