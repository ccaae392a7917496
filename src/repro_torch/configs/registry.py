"""Architecture registry: ``get_config(arch)`` for every configuration of
the JAX package, under its ids -- the dense, vlm and moe decoders, rwkv6
(``ssm``), the zamba2 Mamba2 hybrid (``hybrid``) and whisper's
encoder-decoder (``encdec``) -- and the grid of (arch, shape cell) pairs
(``all_cells``)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import SHAPES, ModelConfig

_ARCH_MODULES = {
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "h2o-danube3-4b": "repro_torch.configs.h2o_danube3_4b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)

# the archs whose trunk is sub-quadratic run long_500k; the pure
# full-attention ones skip it
LONG_CONTEXT_ARCHS = {"gemma3-27b", "h2o-danube3-4b", "zamba2-2.7b",
                      "rwkv6-7b"}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.FULL


def cell_is_applicable(arch: str, shape_name: str) -> bool:
    """Whether an (arch, shape) cell runs or is a recorded skip."""
    if shape_name == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def all_cells(include_skips: bool = False):
    """Yield (arch, ShapeCell, applicable) over the 40-cell grid."""
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            ok = cell_is_applicable(arch, shape.name)
            if ok or include_skips:
                yield arch, shape, ok
