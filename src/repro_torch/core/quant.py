"""Symmetric per-block int8 quantization of frozen frequency tables.

One f32 scale per (p, q) circulant block, shared across the K frequency
bins and the re/im pair; int8 payload. The CUDA kernel dequantizes with the
same float op as :func:`dequantize_symmetric` (``q.float() * scale``), so
the in-kernel dequant and host-side dequant + fp32 kernel give identical
floats. The fixed-point fake-quant family waits for the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["symmetric_scales", "quantize_symmetric", "dequantize_symmetric"]

# Scales are clamped away from zero so all-zero blocks round-trip to exact
# zeros instead of 0/0.
_SCALE_FLOOR = 1e-30


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def symmetric_scales(wr: torch.Tensor, wi: torch.Tensor, bits: int = 8
                     ) -> torch.Tensor:
    """Per-block max-abs scale for an (…, p, q, K) re/im pair:
    ``s = max(|wr|, |wi|) / qmax`` over the K bins, one f32 per block."""
    amax = torch.maximum(wr.abs().amax(dim=-1), wi.abs().amax(dim=-1))
    return torch.clamp(amax.float() / _qmax(bits), min=_SCALE_FLOOR)


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor, bits: int = 8
                       ) -> torch.Tensor:
    """(…, p, q, K) f32 table -> int8 with per-(p, q) ``scale``."""
    if bits > 8:
        raise ValueError(f"int8 storage holds at most 8 bits, got {bits}")
    qm = _qmax(bits)
    q = torch.clamp(torch.round(x.float() / scale[..., None]), -qm, qm)
    return q.to(torch.int8)


def dequantize_symmetric(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_symmetric` — exactly the expression the
    CUDA kernel evaluates on its table tile."""
    return q.float() * scale[..., None]
