"""Architecture registry (port of ``repro.models.registry``): ``--arch <id>``
resolution for the architectures the port runs. The reference's dry-run
shape specs (``SHAPES``, ``input_specs``) describe JAX lowering and are not
ported."""
from __future__ import annotations

import importlib
from typing import Tuple

from .common import ModelConfig

_ARCH_MODULES = {
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "mirage-agent": "repro_torch.configs.mirage_agent",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}


def list_archs() -> Tuple[str, ...]:
    return tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG
