"""Model construction for the launchers."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import HybridDecoderLM

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``device="cpu"``). Tensors are installed afterwards
    with ``nn.module.load_tree``."""
    if cfg.family == "encdec":
        raise NotImplementedError("enc-dec models are not ported yet")
    return HybridDecoderLM(cfg, device=device)
