"""Architecture registry: one module per assigned arch (+ paper CNNs).

Each module exports ``FULL`` (the exact assigned configuration) and
``SMOKE`` (a reduced same-family config for CPU tests).  Select with
``--arch <id>`` in the launchers; ``get(name)`` / ``get_smoke(name)`` here.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig, SHAPES, SHAPES_BY_NAME  # noqa: F401

ARCH_IDS = (
    "qwen1_5_110b",
    "starcoder2_15b",
    "stablelm_12b",
    "qwen3_4b",
    "mamba2_1_3b",
    "internvl2_1b",
    "kimi_k2_1t_a32b",
    "moonshot_v1_16b_a3b",
    "zamba2_2_7b",
    "seamless_m4t_medium",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "qwen1.5-110b": "qwen1_5_110b",
    "mamba2-1.3b": "mamba2_1_3b",
    "zamba2-2.7b": "zamba2_2_7b",
})


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key in ARCH_IDS:
        return key
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}")


def get(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_full() -> Dict[str, ModelConfig]:
    return {i: get(i) for i in ARCH_IDS}
