"""--model registry: id -> (CONFIG, SMOKE), under the reference's names:
every arch of the reference's registry, the decoder family and the
enc-dec arch (seamless-m4t-medium) alike."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS", "LONG_CONTEXT_ARCHS", "get_config", "get_smoke"]

ARCHS: Dict[str, str] = {
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
}

# archs with a sub-quadratic / O(1)-state path that run the long_500k cell
LONG_CONTEXT_ARCHS = {"rwkv6-7b", "jamba-v0.1-52b", "gemma3-27b"}


def _mod(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choices: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE
