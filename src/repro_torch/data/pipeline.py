"""Deterministic synthetic data, numpy only, so every array is the
reference's (``repro.data.pipeline``) for the same seed and step:

  * ``SyntheticLM``       — zipf-ish token ids (B, S+1); structured so that
                            models can learn (next token correlates with
                            the current one)
  * ``synthetic_images``  — MNIST-like 28×28 blobs with class-dependent means
  * ``synthetic_speech``  — TIMIT-like filterbank frames + per-frame labels

The reference's ``host_sharded_batch`` assembles a batch across a device
mesh; it joins the port with the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticLM", "synthetic_images", "synthetic_speech"]


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclasses.dataclass
class SyntheticLM:
    """Markov-ish synthetic LM stream: learnable but non-trivial."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_np(self, step: int) -> Dict[str, np.ndarray]:
        r = _rng(self.seed, step)
        B, S, V = self.batch, self.seq_len + 1, self.vocab
        base = r.integers(0, V, size=(B, 1))
        drift = r.integers(1, 7, size=(B, S)).cumsum(axis=1)
        toks = (base + drift) % V
        noise = r.random((B, S)) < 0.1
        toks = np.where(noise, r.integers(0, V, size=(B, S)), toks)
        return {"tokens": toks.astype(np.int32)}


def synthetic_images(batch: int, step: int, seed: int = 0,
                     hw: int = 28, n_classes: int = 10):
    """(x (B, hw, hw, 1), y (B,)) — class-dependent gaussians, learnable."""
    r = _rng(seed, step)
    y = r.integers(0, n_classes, size=(batch,))
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, hw), np.linspace(-1, 1, hw)),
                    -1)
    ang = 2 * np.pi * y / n_classes
    centers = np.stack([np.cos(ang), np.sin(ang)], -1) * 0.5
    d = ((grid[None] - centers[:, None, None, :]) ** 2).sum(-1)
    x = np.exp(-d * 8) + 0.3 * r.standard_normal((batch, hw, hw))
    return x[..., None].astype(np.float32), y.astype(np.int32)


def synthetic_speech(batch: int, frames: int, dim: int, step: int,
                     seed: int = 0, n_phones: int = 39):
    """Filterbank-like frames with per-frame phone labels.

    Phone prototypes are drawn from `seed` only (fixed across steps — a
    step-dependent prototype table would make the task unlearnable)."""
    proto = np.random.default_rng(seed).standard_normal((n_phones, dim)) * 0.5
    r = _rng(seed, step)
    y = r.integers(0, n_phones, size=(batch, frames))
    x = proto[y] + 0.3 * r.standard_normal((batch, frames, dim))
    return x.astype(np.float32), y.astype(np.int32)
