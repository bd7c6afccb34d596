"""Architecture registry of the port: ``get_config(arch_id)``."""

from __future__ import annotations

import importlib

ARCH_IDS = ["smollm-135m", "phi4-mini-3.8b", "phi3-mini-3.8b", "gemma-7b",
            "deepseek-v2-236b", "deepseek-v3-671b"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
