"""Model construction and batch shapes for the launchers."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.decoder import HybridDecoderLM
from repro_torch.models.encdec import EncDecLM

__all__ = ["batch_specs", "build_model"]


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``device="cpu"``): :class:`EncDecLM` for the
    enc-dec family, :class:`HybridDecoderLM` otherwise. Tensors are
    installed afterwards with ``nn.module.load_tree``."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device)
    return HybridDecoderLM(cfg, device=device)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """A training batch's ``{name: (shape, dtype)}``, the reference's
    ``batch_specs`` without shardings: ``tokens`` (B, S+1) int32 (S+1 for
    next-token labels); a vlm's ``img`` (B, n_img_tokens, d_model) bf16; an
    enc-dec model's ``frames`` (B, min(S, enc_seq), d_model) bf16."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S + 1), torch.int32)}
    if cfg.family == "vlm":
        specs["img"] = ((B, cfg.n_img_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = ((B, min(S, cfg.enc_seq or S), cfg.d_model),
                           torch.bfloat16)
    return specs
