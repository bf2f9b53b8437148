"""Architecture config registry: ``get_config(<id>)`` resolution.

Only the paper's own model is registered so far; the other families of
``repro.configs`` join as their model code is ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: F401

ARCH_IDS = (
    "mixtral_8x7b",   # the paper's own evaluation model
)


def _module_for(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    mod_name = _module_for(name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported architecture {name!r}; "
                       f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
