"""Architecture config registry.

``get_config(arch_id)`` returns the FULL config; ``get_smoke_config`` returns
a reduced same-family config for CPU tests.  The dense family, the ssm
family (Mamba1, and Mamba2 at ``ssm.version`` 2), the moe family (with
DeepSeek's MLA) and the hybrid family (Mamba2 blocks with one shared
attention block, zamba2) are ported so far; asking for any other
architecture raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.core.config import ModelConfig

ARCH_IDS: List[str] = [
    "gemma3_1b",
    "tinyllama_1_1b",
    "gemma_2b",
    "phi3_mini_3_8b",
    "falcon_mamba_7b",
    "granite_moe_1b_a400m",
    "deepseek_v2_lite_16b",
    "zamba2_2_7b",
]

# architectures of the reference registry whose family the port lacks
UNPORTED = {
    "whisper_small": "encdec",
    "internvl2_26b": "vlm",
}

# accept dashed ids on the CLI
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS + list(UNPORTED)}


def _module(arch_id: str):
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is of the {UNPORTED[arch_id]!r} family, which "
            f"repro_torch has not ported yet; ported: {ARCH_IDS}")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
