"""Architecture registry: the 10 assigned configs (+ the paper's Jacobi
experiment config) selectable via ``--arch <id>``."""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPE_CELLS, ModelConfig, ShapeCell

_MODULES = {
    "whisper-base": "whisper_base",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma3-4b": "gemma3_4b",
    "llama3-405b": "llama3_405b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-370m": "mamba2_370m",
}

ARCHS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def cells_for(arch: str) -> tuple[str, ...]:
    """Shape cells assigned to this arch (long_500k per DESIGN.md §4)."""
    return _mod(arch).CELLS


def all_cells() -> list[tuple[str, str]]:
    return [(a, c) for a in ARCHS for c in cells_for(a)]
