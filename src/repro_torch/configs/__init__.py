"""Architecture registry: ``get_config(arch_id)`` + shape cells."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401  (public re-exports)
    FULL_ATTENTION,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_is_runnable,
)

_ARCH_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "dbrx-132b": "dbrx_132b",
    "whisper-large-v3": "whisper_large_v3",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_cells():
    """Yield every runnable (arch, shape) dry-run cell."""
    for arch in ARCHS:
        for shape in SHAPES:
            if cell_is_runnable(arch, shape):
                yield arch, shape
