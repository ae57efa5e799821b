"""Shared building blocks: RMSNorm, embeddings, rotary position embedding.

Under tensor parallelism an :class:`Embedding` whose ``vocab`` rows are
split over the ``model`` axis (``tp`` = (axis, first row, end row), set by
``dist.tensor_parallel.shard_model``) looks each token up in its own rows
only, zeros elsewhere, and sums the ranks' lookups; its tied logits head
gathers the ranks' logit slices."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.nn.module import ParamSpec

__all__ = ["RMSNorm", "Embedding", "rotary", "apply_rope"]


class RMSNorm(nn.Module):
    """Gemma-style RMSNorm: ``x·rsqrt(mean(x²)+eps)·(1 + scale)`` in f32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.dim, self.eps = int(dim), float(eps)

    def specs(self):
        return {"scale": ParamSpec((self.dim,), torch.float32,
                                   init="zeros", axes=(None,))}

    def forward(self, x: torch.Tensor, scale=None) -> torch.Tensor:
        """``scale`` takes the place of the module's own for this call."""
        dtype = x.dtype
        x = x.float()
        var = x.square().mean(dim=-1, keepdim=True)
        if scale is None:
            scale = self._buffers["scale"]
        y = x * torch.rsqrt(var + self.eps) * (1.0 + scale)
        return y.to(dtype)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype: str = "bfloat16"):
        super().__init__()
        self.vocab, self.dim, self.dtype = int(vocab), int(dim), dtype
        self.tp = None

    def specs(self):
        return {"table": ParamSpec((self.vocab, self.dim), self.dtype,
                                   scale=1.0, axes=("vocab", "embed"))}

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the table, scaled by √dim in the table's dtype."""
        table = self._buffers["table"]
        if self.tp is None:
            x = table[tokens]
        else:
            from repro_torch.dist.sharding import region_output

            axis, start, stop = self.tp
            rel = tokens.long() - start
            mine = (rel >= 0) & (rel < stop - start)
            x = table[rel.clamp(0, stop - start - 1)]
            x = region_output(x * mine[..., None].to(x.dtype), axis)
        return x * torch.tensor(self.dim ** 0.5, dtype=x.dtype,
                                device=x.device)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """Tied logits head: (..., d) @ (vocab, d)^T -> f32 logits."""
        if self.tp is None:
            return x.float() @ self._buffers["table"].float().T
        from repro_torch.dist.sharding import gather_replicated, region_input

        axis, table = self.tp[0], self._buffers["table"]
        local = region_input(x, axis).float() @ table.float().T
        return gather_replicated(local, axis, -1)


def rotary(positions: torch.Tensor, head_dim: int, theta: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, head_dim/2), f32."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=positions.device) / head_dim
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
