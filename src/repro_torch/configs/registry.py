"""Architecture registry: ``get_config(arch)`` for the configurations the
port runs.  The ids are the JAX package's; an architecture whose family
or layer pattern the port does not run yet raises ``NotImplementedError``
(``ROADMAP.md`` queues it)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}
# the JAX package's other architectures: MoE, rwkv/ssm, hybrid, encdec and
# the window / local-global attention patterns come with later slices
_NOT_PORTED = ("deepseek-67b", "gemma3-27b", "h2o-danube3-4b",
               "mistral-nemo-12b", "whisper-small", "zamba2-2.7b",
               "rwkv6-7b", "qwen3-moe-235b-a22b", "deepseek-moe-16b")

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet; ROADMAP.md queues "
            f"its family; available: {ARCH_IDS}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.FULL
