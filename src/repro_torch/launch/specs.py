"""Model construction, parameter counts and batch shapes for the
launchers."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.decoder import HybridDecoderLM
from repro_torch.models.encdec import EncDecLM
from repro_torch.nn.module import _walk

__all__ = ["batch_specs", "build_model", "count_params"]


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``device="cpu"``): :class:`EncDecLM` for the
    enc-dec family, :class:`HybridDecoderLM` otherwise. Tensors are
    installed afterwards with ``nn.module.load_tree``."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device)
    return HybridDecoderLM(cfg, device=device)


def count_params(cfg: ModelConfig) -> Dict[str, float]:
    """Stored, active and dense-equivalent parameter counts, read off the
    model's specs (bookkeeping: no tensor is made, on any device).

    * ``stored``: what the model holds (an SWM table is m·n/k);
    * ``*_active``: MoE experts scaled by top_k / E;
    * ``dense*``: the same model with SWM off, the compression denominator;
    * ``head_n`` / ``body_n`` / ``flops_n``: the FLOP-relevant split — the
      embedding gather costs ~0 FLOPs, the vocab projection one d×V matmul
      per logit position.
    """
    def counts(c: ModelConfig):
        # the device only places caches, which are never made here
        model = build_model(c, device="cpu")
        total = active = embed = 0
        frac = (c.n_experts_per_token / c.n_experts) if c.n_experts else 1.0
        for path, spec in _walk(model.specs()):
            n = int(np.prod(spec.shape))
            total += n
            in_moe = any("ffn_moe" in p or p == "experts" for p in path)
            active += n * (frac if in_moe else 1.0)
            if path[0] == "embed":
                embed += n
        return total, active, embed

    stored, stored_active, embed = counts(cfg)
    dense, dense_active, _ = counts(dataclasses.replace(
        cfg, swm=dataclasses.replace(cfg.swm, block_size=0)))
    head = cfg.d_model * cfg.vocab
    body = stored_active - embed - (0 if cfg.tie_embeddings else head)
    return {
        "stored": stored, "stored_active": stored_active,
        "dense": dense, "dense_active": dense_active,
        "embed": embed,
        "head_n": head,
        "body_n": max(body, 0),
        "flops_n": max(body, 0) + head,
        "compression": dense / max(stored, 1),
    }


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
