"""--arch <id> resolution for the ported architectures."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduce_for_smoke

# only architectures whose every block kind is ported
_MODULES = {
    "yi-6b": "yi_6b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; ported: "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduce_for_smoke(get_config(arch))
