"""Registry mapping --arch ids to ModelConfigs (full + reduced smoke variants)."""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "nemotron-4-15b",
    "gemma3-4b",
    "zamba2-1.2b",
    "mamba2-370m",
    "phi3.5-moe-42b-a6.6b",
    "musicgen-medium",
    "h2o-danube-3-4b",
    "qwen3-moe-30b-a3b",
    "pixtral-12b",
    "chatglm3-6b",
)

_MODULES = {
    "nemotron-4-15b": "nemotron_4_15b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-370m": "mamba2_370m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "musicgen-medium": "musicgen_medium",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen3-moe-30b-a3b": "qwen3_moe",
    "pixtral-12b": "pixtral_12b",
    "chatglm3-6b": "chatglm3_6b",
}


def get_config(arch: str, *, reduced: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced_config() if reduced else mod.config()


def all_configs(reduced: bool = False) -> dict:
    return {a: get_config(a, reduced=reduced) for a in ARCH_IDS}
