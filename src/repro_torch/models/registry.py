"""Architecture registry: ``--arch <id>`` -> (full config, smoke config).
The port's copy of the JAX package's ``models/registry.py``, over the
port's own config modules. Every config is listed, and the port's model
runs each of them."""
from __future__ import annotations

from importlib import import_module

from ..configs.base import ArchConfig

_MODULES = {
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = import_module(_MODULES[arch_id])
    return mod.SMOKE if smoke else mod.FULL


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCH_IDS}
