"""Fixed-point and symmetric int8 quantization (paper §4.1).

The paper runs its DCNN at 12-bit and its LSTM at 16-bit fixed point. Two
families live here, as in the reference (``repro/core/quant.py``):

* ``fixed_point`` / ``quantize_tree`` — fake-quantize to a global signed
  (bits).(frac_bits) grid with a clipped straight-through gradient (the
  cotangent passes only where the forward did not saturate at the rails),
  for the paper models' ``quant_bits`` and quantization-aware training.
  ``quantize_tree`` takes complex leaves through their re/im parts and an
  ``exempt`` predicate for biases and norm scales.
* ``symmetric_scales`` / ``quantize_symmetric`` / ``dequantize_symmetric``
  / ``fake_quant_symmetric`` — symmetric int8 for frozen frequency tables:
  one f32 scale per (p, q) circulant block, shared across the K frequency
  bins and the re/im pair. The CUDA kernel dequantizes with the same float
  op as :func:`dequantize_symmetric` (``q.float() * scale``), so in-kernel
  dequant and host-side dequant + fp32 kernel give identical floats.

``torch.round`` rounds half to even, as ``jnp.round`` does, so both
packages put an f32 value on the same grid point.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["fixed_point", "quantize_tree", "default_exempt",
           "symmetric_scales", "quantize_symmetric", "dequantize_symmetric",
           "fake_quant_symmetric"]

# Scales are clamped away from zero so all-zero blocks round-trip to exact
# zeros instead of 0/0.
_SCALE_FLOOR = 1e-30


# ---------------------------------------------------------------------------
# Fixed point
# ---------------------------------------------------------------------------


def _rails(bits: int, frac_bits: int):
    """(lo, hi) representable range of signed (bits).(frac_bits) fixed
    point."""
    scale = float(2 ** frac_bits)
    return -(2 ** (bits - 1)) / scale, (2 ** (bits - 1) - 1) / scale


class _FixedPoint(torch.autograd.Function):
    """``round(x·2^f)/2^f`` clipped to the rails, in x's dtype; the
    backward passes g only where ``lo <= x <= hi``."""

    @staticmethod
    def forward(ctx, x, bits, frac_bits):
        scale = float(2 ** frac_bits)
        lo, hi = _rails(bits, frac_bits)
        ctx.save_for_backward(x)
        ctx.rails = (lo, hi)
        q = torch.round(x.float() * scale) / scale
        return torch.clamp(q, lo, hi).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.rails
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, g, torch.zeros_like(g)), None, None


def fixed_point(x: torch.Tensor, bits: int = 12, frac_bits: int = 8
                ) -> torch.Tensor:
    """Round to signed (bits).(frac_bits) fixed point; clipped-STE
    gradient (a value pinned at a rail takes no gradient)."""
    return _FixedPoint.apply(x, int(bits), int(frac_bits))


def default_exempt(path_names) -> bool:
    """Default QAT exemption: biases and norm scales, whose dynamic range
    is unrelated to the weight rails. Matches leaf keys named ``bias``,
    ``scale``, ``w_scale``, ``gamma``, ``beta``, short b-prefixed keys
    (``b``, ``b0``, ``bi``…) and ``*_b``."""
    name = path_names[-1] if path_names else ""
    if name in ("bias", "scale", "w_scale", "gamma", "beta"):
        return True
    return (name.startswith("b") and len(name) <= 3) or name.endswith("_b")


def quantize_tree(params, bits: int = 12, frac_bits: int = 8,
                  exempt: Optional[Callable] = None):
    """Fake-quantize every floating and complex leaf of a nested-dict param
    tree; integer leaves pass through. Complex leaves quantize through
    their re/im parts. ``exempt`` is a predicate over the tuple of key
    names from the root (see :func:`default_exempt`); exempt leaves pass
    through untouched. Returns a new tree; the input is not modified."""
    def q(path, x):
        if isinstance(x, dict):
            return {k: q(path + (str(k),), v) for k, v in x.items()}
        if exempt is not None and exempt(path):
            return x
        if x.is_complex():
            re = fixed_point(x.real, bits, frac_bits)
            im = fixed_point(x.imag, bits, frac_bits)
            return torch.complex(re, im).to(x.dtype)
        if x.is_floating_point():
            return fixed_point(x, bits, frac_bits)
        return x

    return q((), params)


# ---------------------------------------------------------------------------
# Symmetric per-block int8 (frozen frequency tables)
# ---------------------------------------------------------------------------


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


class _FqSym(torch.autograd.Function):
    """dequant(quant(x)) at fixed ``scale``; clipped-STE gradient to x,
    none to the scale (quantization grids take no gradient)."""

    @staticmethod
    def forward(ctx, x, scale, bits):
        qm = _qmax(bits)
        ctx.save_for_backward(x, scale)
        ctx.qm = qm
        q = torch.clamp(torch.round(x.float() / scale[..., None]), -qm, qm)
        return (q * scale[..., None]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        lim = ctx.qm * scale[..., None]
        inside = (x >= -lim) & (x <= lim)
        return (torch.where(inside, g, torch.zeros_like(g)),
                torch.zeros_like(scale), None)


def fake_quant_symmetric(wr: torch.Tensor, wi: torch.Tensor, bits: int = 8):
    """QAT / oracle counterpart of the int8 freeze: ``(wr_fq, wi_fq,
    scale)``. The scales come from the pair without gradient; the tables
    equal ``dequantize_symmetric(quantize_symmetric(w, s), s)`` bit for
    bit, with a clipped-STE gradient (zero where the forward clipped at
    ±qmax·s, which max-abs scales never do)."""
    with torch.no_grad():
        scale = symmetric_scales(wr, wi, bits)
    return (_FqSym.apply(wr, scale, int(bits)),
            _FqSym.apply(wi, scale, int(bits)), scale)
