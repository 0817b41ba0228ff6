"""Architecture config registry.

``get_config(arch_id)`` returns the FULL config; ``get_smoke_config`` returns
a reduced same-family config for CPU tests.  Every architecture of the
reference's registry is here, in every family: dense, ssm (Mamba1, and
Mamba2 at ``ssm.version`` 2), moe (with DeepSeek's MLA), hybrid (Mamba2
blocks with one shared attention block, zamba2), encdec (whisper) and vlm
(InternVL2).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

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
    "whisper_small",
    "internvl2_26b",
]

# accept dashed ids on the CLI
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(arch_id: str):
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    """Every architecture's FULL config, by id in ``ARCH_IDS`` order."""
    return {a: get_config(a) for a in ARCH_IDS}
