"""Model construction for the launchers."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import HybridDecoderLM
from repro_torch.models.encdec import EncDecLM

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``device="cpu"``): :class:`EncDecLM` for the
    enc-dec family, :class:`HybridDecoderLM` otherwise. Tensors are
    installed afterwards with ``nn.module.load_tree``."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device)
    return HybridDecoderLM(cfg, device=device)
