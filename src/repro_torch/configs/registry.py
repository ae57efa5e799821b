"""--model registry: id -> (CONFIG, SMOKE). Only the archs the port
serves so far are listed, under the reference's names; the others join
with their model families."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS", "get_config", "get_smoke"]

ARCHS: Dict[str, str] = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
}


def _mod(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choices: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE
