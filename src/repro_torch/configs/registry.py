"""--arch <id> resolution for the ported architectures."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduce_for_smoke

# every architecture of the reference
_MODULES = {
    "yi-6b": "yi_6b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "minicpm3-4b": "minicpm3_4b",
    "chatglm3-6b": "chatglm3_6b",
    "whisper-small": "whisper_small",
    "deepseek-7b": "deepseek_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-2.7b": "mamba2_2_7b",
    "grok-1-314b": "grok_1_314b",
    "arctic-480b": "arctic_480b",
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
