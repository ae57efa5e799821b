"""Block-circulant (SWM) linear algebra — the paper's core technique.

A weight ``W ∈ R^{m×n}`` is partitioned into ``p×q`` square blocks of size
``k``; each block ``W_ij`` is the circulant matrix whose **first column**
is ``w_ij``, i.e. ``W_ij[a, b] = w_ij[(a - b) mod k]``, so ``W_ij @ x`` is
the circular convolution ``w ⊛ x`` and

    W_ij @ x_j = IFFT( FFT(w_ij) ∘ FFT(x_j) ).

Forward implementations, selectable per layer (``impl=``):

  * ``paper``  — one inverse transform per (i, j) block, accumulated in the
                 time domain (the paper's ASIC dataflow, §5.2);
  * ``freq``   — accumulate in the frequency domain, one inverse transform
                 per output block;
  * ``dft``    — the rDFT of a length-k block as a dense matmul against
                 real cos/sin bases and the frequency contraction as
                 per-bin real einsums (``karatsuba`` takes 3 instead of 4),
                 in stock torch ops with a hand-written backward that keeps
                 only ``(x, w)``;
  * ``pallas`` — the fused kernel path (``kernels.block_circulant``): the
                 hand-written CUDA kernel on the card, its plain PyTorch
                 version on the CPU.

All share the parameterization: the time-domain table ``w (p, q, k)``;
inference may precompute ``rfft(w)`` once ("frozen frequency weights").
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "blocks_to_dense",
    "valid_block_size",
    "block_circulant_matvec_paper",
    "block_circulant_matvec_freq",
    "block_circulant_matvec_dft",
    "block_circulant_apply",
    "block_circulant_apply_pair",
    "block_circulant_apply_fused",
    "block_circulant_apply_multi",
    "dequantize_freq_pair",
    "concat_biases",
    "split_outputs",
    "dft_bases",
    "dft_bases_adjoint",
    "dense_to_blocks_lstsq",
    "dense_flops",
    "swm_flops",
]


# ---------------------------------------------------------------------------
# Reference / conversion utilities
# ---------------------------------------------------------------------------


def blocks_to_dense(w: torch.Tensor) -> torch.Tensor:
    """Expand ``w (p, q, k)`` to the dense ``(p·k, q·k)`` W:
    ``W[i·k + a, j·k + b] = w[i, j, (a - b) mod k]``. Oracle only."""
    p, q, k = w.shape
    a = torch.arange(k, device=w.device)
    idx = (a[:, None] - a[None, :]) % k
    blocks = w[:, :, idx]                                   # (p, q, k, k)
    return blocks.permute(0, 2, 1, 3).reshape(p * k, q * k)


def dense_to_blocks_lstsq(W: torch.Tensor, k: int) -> torch.Tensor:
    """The nearest block-circulant table (Frobenius) to a dense ``W (m,
    n)``: each k×k block's circulant fit is the mean over its circulant
    diagonals, ``w[d] = mean_a B[a, (a - d) mod k]``. Initializes SWM
    layers from dense checkpoints."""
    m, n = W.shape
    if m % k or n % k:
        raise ValueError(f"dims ({m},{n}) not divisible by k={k}")
    p, q = m // k, n // k
    blocks = W.reshape(p, k, q, k).permute(0, 2, 1, 3)     # (p, q, k, k)
    a = torch.arange(k, device=W.device)
    cols = (a[None, :] - a[:, None]) % k                   # (d, a) -> col
    return blocks[:, :, a[None, :], cols].mean(-1)         # (p, q, k)


def valid_block_size(requested: int, *dims: int) -> int:
    """Largest k ≤ requested dividing every dim (k=1 is the floor)."""
    g = 0
    for d in dims:
        g = math.gcd(g, int(d))
    k = min(max(1, int(requested)), g)
    while g % k:
        k -= 1
    return k


# ---------------------------------------------------------------------------
# FFT-path forwards
# ---------------------------------------------------------------------------


def _split_blocks(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., n) -> (..., q, k)."""
    *lead, n = x.shape
    if n % k:
        raise ValueError(f"feature dim {n} is not a multiple of k={k}")
    return x.reshape(*lead, n // k, k)


def block_circulant_matvec_paper(x: torch.Tensor, w: torch.Tensor
                                 ) -> torch.Tensor:
    """``y_i = Σ_j IFFT(ŵ_ij ∘ x̂_j)``: one inverse transform per (i, j)
    block, summed in the time domain one input block at a time.
    x (..., q·k), w (p, q, k) -> (..., p·k)."""
    p, q, k = w.shape
    xh = torch.fft.rfft(_split_blocks(x, k).float(), dim=-1)  # (..., q, K)
    wh = torch.fft.rfft(w.float(), dim=-1)                     # (p, q, K)
    acc = torch.zeros((*x.shape[:-1], p, k), dtype=torch.float32,
                      device=x.device)
    for j in range(q):
        acc = acc + torch.fft.irfft(xh[..., j, None, :] * wh[:, j], n=k,
                                    dim=-1)
    return acc.reshape(*x.shape[:-1], p * k).to(x.dtype)


def block_circulant_matvec_freq(
    x: torch.Tensor, w: Optional[torch.Tensor], *,
    w_freq: Optional[torch.Tensor] = None, k: Optional[int] = None,
) -> torch.Tensor:
    """``y_i = IFFT(Σ_j ŵ_ij ∘ x̂_j)``: one inverse transform per output
    block. ``w_freq (p, q, K)`` complex takes frozen weights; pass ``k``
    alongside when w is None (K alone is ambiguous for odd k)."""
    if w_freq is None:
        p, q, k = w.shape
        w_freq = torch.fft.rfft(w.float(), dim=-1)
    else:
        p, q = w_freq.shape[:2]
        if k is None:
            k = (w_freq.shape[-1] - 1) * 2 if w is None else w.shape[-1]
    xh = torch.fft.rfft(_split_blocks(x, k).float(), dim=-1)   # (..., q, K)
    yh = torch.einsum("...qf,pqf->...pf", xh, w_freq)         # (..., p, K)
    yb = torch.fft.irfft(yh, n=k, dim=-1)                      # (..., p, k)
    return yb.reshape(*x.shape[:-1], p * k).to(x.dtype)


# ---------------------------------------------------------------------------
# rDFT bases (the kernel computes the transforms as matmuls)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _dft_bases_np(k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Real rDFT analysis/synthesis bases as numpy constants.

    Analysis (x (.., k) real -> X (.., K) complex, K = k//2+1):
        Xr = x @ C,   Xi = x @ S          C[a,f]=cos(2πaf/k), S[a,f]=-sin(2πaf/k)
    Synthesis (X -> y (.., k) real):
        y = Xr @ Ci + Xi @ Si
        Ci[f,a] = g_f·cos(2πaf/k)/k,  Si[f,a] = -g_f·sin(2πaf/k)/k
        g_f = 1 for f ∈ {0, k/2}, else 2   (Hermitian-symmetry fold; for odd
        k only f=0 is unpaired)
    """
    K = k // 2 + 1
    a = np.arange(k)[:, None]
    f = np.arange(K)[None, :]
    ang = 2.0 * np.pi * a * f / k
    C = np.cos(ang)
    S = -np.sin(ang)
    g = np.full((K,), 2.0)
    g[0] = 1.0
    if k % 2 == 0:
        g[-1] = 1.0
    Ci = (g[:, None] * np.cos(ang).T) / k
    Si = -(g[:, None] * np.sin(ang).T) / k
    return (C.astype(np.float32), S.astype(np.float32),
            Ci.astype(np.float32), Si.astype(np.float32))


@functools.lru_cache(maxsize=64)
def dft_bases(k: int, device="cpu"):
    """``(C, S, Ci, Si)`` as contiguous f32 tensors: C/S (k, K), Ci/Si
    (K, k). Built once per (k, device) and shared by every caller, so no
    call copies host memory to the device; callers never write to them."""
    return tuple(torch.from_numpy(b).to(device).contiguous()
                 for b in _dft_bases_np(k))


@functools.lru_cache(maxsize=64)
def _dft_bases_adjoint_np(k: int):
    C, S, Ci, Si = _dft_bases_np(k)
    return (C, S, np.ascontiguousarray(Ci.T), np.ascontiguousarray(Si.T),
            np.ascontiguousarray(C.T), np.ascontiguousarray(S.T))


@functools.lru_cache(maxsize=64)
def dft_bases_adjoint(k: int, device="cpu"):
    """Bases of the weight adjoint ``(C, S, CiT, SiT, CT, ST)`` as
    contiguous f32 tensors, cached per (k, device) like :func:`dft_bases`:

      * ``C, S`` (k, K) — analysis bases for x̂;
      * ``CiT, SiT`` (k, K) — adjoint of the inverse rDFT, applied to the
        upstream cotangent: ``gyr = g @ Ciᵀ``, ``gyi = g @ Siᵀ``;
      * ``CT, ST`` (K, k) — adjoint of the forward rDFT, folding the
        frequency cotangent back to the time domain:
        ``dw = dwr @ Cᵀ + dwi @ Sᵀ``.
    """
    return tuple(torch.from_numpy(b).to(device).contiguous()
                 for b in _dft_bases_adjoint_np(k))


# ---------------------------------------------------------------------------
# DFT-as-matmul path
# ---------------------------------------------------------------------------
#
# Products take operands in the compute dtype ``cdt`` (the input's) and
# accumulate in f32, as the reference's ``preferred_element_type=f32``: the
# operands go up to f32 (exact for bf16) before each matmul or einsum, and
# a sum of two accumulated terms is taken in f32 before it is cast to cdt.


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _ein(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.float(), b.float())


def _bases(k: int, cdt: torch.dtype, device):
    return tuple(b.to(cdt) for b in dft_bases(k, device))


def _freq(t: torch.Tensor, C: torch.Tensor, S: torch.Tensor, cdt):
    """Real and imaginary rDFT of the last axis, each cast to cdt."""
    return _mm(t, C).to(cdt), _mm(t, S).to(cdt)


def _dft_fwd_math(x: torch.Tensor, w: torch.Tensor, karatsuba: bool,
                  cdt: torch.dtype) -> torch.Tensor:
    p, q, k = w.shape
    C, S, Ci, Si = _bases(k, cdt, x.device)
    xr, xi = _freq(_split_blocks(x, k).to(cdt), C, S, cdt)    # (..., q, K)
    wr, wi = _freq(w.to(cdt), C, S, cdt)                      # (p, q, K)
    eq = "...qf,pqf->...pf"
    if karatsuba:
        # (xr + i·xi)(wr + i·wi): t1 = xr·wr, t2 = xi·wi,
        # yr = t1 - t2, yi = (xr+xi)(wr+wi) - t1 - t2
        t1, t2 = _ein(eq, xr, wr), _ein(eq, xi, wi)
        t3 = _ein(eq, xr + xi, wr + wi)
        yr, yi = (t1 - t2).to(cdt), (t3 - t1 - t2).to(cdt)
    else:
        yr = (_ein(eq, xr, wr) - _ein(eq, xi, wi)).to(cdt)
        yi = (_ein(eq, xr, wi) + _ein(eq, xi, wr)).to(cdt)
    yb = _mm(yr, Ci) + _mm(yi, Si)                            # (..., p, k)
    return yb.reshape(*x.shape[:-1], p * k).to(x.dtype)


def _dft_bwd(x2d: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(dx, dw) of the DFT path: the circulant adjoints with operands in
    x's dtype and f32 accumulation; the frequency operands are recomputed
    from ``(x2d, w)``."""
    p, q, k = w.shape
    cdt = x2d.dtype
    C, S, Ci, Si = _bases(k, cdt, x2d.device)
    xr, xi = _freq(_split_blocks(x2d, k).to(cdt), C, S, cdt)
    wr, wi = _freq(w.to(cdt), C, S, cdt)
    gb = g.reshape(*g.shape[:-1], p, k).to(cdt)
    # adjoint of the inverse rDFT (y = yr@Ci + yi@Si)
    gyr, gyi = _freq(gb, Ci.T, Si.T, cdt)                     # (..., p, K)
    # adjoints of the per-bin complex GEMM
    ex, ew = "...pf,pqf->...qf", "...pf,...qf->pqf"
    dxr = (_ein(ex, gyr, wr) + _ein(ex, gyi, wi)).to(cdt)
    dxi = (_ein(ex, gyi, wr) - _ein(ex, gyr, wi)).to(cdt)
    dwr = _ein(ew, gyr, xr) + _ein(ew, gyi, xi)
    dwi = _ein(ew, gyi, xr) - _ein(ew, gyr, xi)
    # adjoint of the forward rDFT (xr = x@C, xi = x@S)
    dx = (_mm(dxr, C.T) + _mm(dxi, S.T)).reshape(x2d.shape).to(x2d.dtype)
    dw = (_mm(dwr.to(cdt), C.T) + _mm(dwi.to(cdt), S.T)).to(w.dtype)
    return dx, dw


class _DftOp(torch.autograd.Function):
    """2-D core of the DFT path, ``x2d (N, q·k)``, ``w (p, q, k)``. Its
    backward (:func:`_dft_bwd`) saves only ``(x2d, w)`` and recomputes the
    frequency operands instead of keeping them."""

    @staticmethod
    def forward(ctx, x2d, w, karatsuba):
        ctx.save_for_backward(x2d, w)
        return _dft_fwd_math(x2d, w, karatsuba, x2d.dtype)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        dx, dw = _dft_bwd(x2d, w, g)
        return dx, dw, None


def block_circulant_matvec_dft(x: torch.Tensor, w: torch.Tensor, *,
                               karatsuba: bool = False,
                               compute_dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """rDFT as a dense matmul, per-bin complex GEMM, inverse matmul. x
    (..., q·k), w (p, q, k) -> (..., p·k) in x's dtype (after the cast to
    ``compute_dtype`` when given). ``karatsuba=True`` takes the complex
    contraction in 3 real einsums instead of 4."""
    if compute_dtype is not None and compute_dtype != x.dtype:
        x = x.to(compute_dtype)
    lead = x.shape[:-1]
    y = _DftOp.apply(x.reshape(-1, x.shape[-1]), w, bool(karatsuba))
    return y.reshape(*lead, y.shape[-1])


def _dft_pair_fwd_math(x2d, w1, w2):
    k = w1.shape[-1]
    cdt = x2d.dtype
    C, S, Ci, Si = _bases(k, cdt, x2d.device)
    xr, xi = _freq(_split_blocks(x2d, k).to(cdt), C, S, cdt)  # shared

    def one(w):
        wr, wi = _freq(w.to(cdt), C, S, cdt)
        eq = "...qf,pqf->...pf"
        yr = (_ein(eq, xr, wr) - _ein(eq, xi, wi)).to(cdt)
        yi = (_ein(eq, xr, wi) + _ein(eq, xi, wr)).to(cdt)
        y = _mm(yr, Ci) + _mm(yi, Si)
        return y.reshape(x2d.shape[0], w.shape[0] * k).to(x2d.dtype)

    return one(w1), one(w2)


class _DftPairOp(torch.autograd.Function):
    """Two circulant projections of one ``x2d`` sharing its forward DFT
    (SwiGLU's gate and up); each backward is :func:`_dft_bwd`."""

    @staticmethod
    def forward(ctx, x2d, w1, w2):
        ctx.save_for_backward(x2d, w1, w2)
        return _dft_pair_fwd_math(x2d, w1, w2)

    @staticmethod
    def backward(ctx, g1, g2):
        x2d, w1, w2 = ctx.saved_tensors
        dx1, dw1 = _dft_bwd(x2d, w1, g1)
        dx2, dw2 = _dft_bwd(x2d, w2, g2)
        return dx1 + dx2, dw1, dw2


def block_circulant_apply_pair(x: torch.Tensor, w1: torch.Tensor,
                               w2: torch.Tensor):
    """(y1, y2) = (BC(w1)·x, BC(w2)·x) on the DFT path with one shared
    forward transform of x."""
    lead = x.shape[:-1]
    y1, y2 = _DftPairOp.apply(x.reshape(-1, x.shape[-1]), w1, w2)
    return (y1.reshape(*lead, y1.shape[-1]),
            y2.reshape(*lead, y2.shape[-1]))


# ---------------------------------------------------------------------------
# Unified entry points
# ---------------------------------------------------------------------------


def block_circulant_apply(x: torch.Tensor, w: torch.Tensor, *,
                          impl: str = "freq",
                          karatsuba: bool = False) -> torch.Tensor:
    """Dispatch on implementation. x (..., q·k), w (p, q, k) -> (..., p·k).
    ``karatsuba`` reaches the ``dft`` impl only."""
    if impl == "paper":
        return block_circulant_matvec_paper(x, w)
    if impl == "freq":
        return block_circulant_matvec_freq(x, w)
    if impl == "dft":
        return block_circulant_matvec_dft(x, w, karatsuba=karatsuba)
    if impl == "pallas":
        from repro_torch.kernels.block_circulant import ops as bc_ops

        return bc_ops.block_circulant_matmul(x, w)
    if impl == "freq_shmap":
        # the reference shard_maps the activation transforms over the
        # ambient mesh's data axes; under the port's eager data
        # parallelism each rank already holds only its batch rows, so the
        # transforms are the freq path on this rank's rows
        lead = x.shape[:-1]
        y = block_circulant_matvec_freq(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*lead, y.shape[-1])
    raise ValueError(f"unknown impl {impl!r}")


def _epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
              activation: str) -> torch.Tensor:
    from repro_torch.kernels.block_circulant.kernel import apply_activation

    if bias is not None:
        y = y + bias.to(y.dtype)
    return apply_activation(y, activation)


def dequantize_freq_pair(wr: torch.Tensor, wi: torch.Tensor,
                         w_scale: Optional[torch.Tensor]):
    """int8 frozen pair + per-(p, q)-block scale -> f32 pair (no-op when
    ``w_scale`` is None); the same float ops as the kernel's dequant."""
    if w_scale is None:
        return wr, wi
    from repro_torch.core.quant import dequantize_symmetric

    return (dequantize_symmetric(wr, w_scale),
            dequantize_symmetric(wi, w_scale))


def _as_complex(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    return torch.complex(wr.float(), wi.float())


def block_circulant_apply_fused(
    x: torch.Tensor,
    w: Optional[torch.Tensor],
    *,
    impl: str = "freq",
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    w_freq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_scale: Optional[torch.Tensor] = None,
    k: Optional[int] = None,
    karatsuba: bool = False,
) -> torch.Tensor:
    """One projection with the bias/activation epilogue and (optionally)
    frozen frequency weights ``w_freq=(wr, wi)``.

    ``impl='pallas'`` fuses everything into the kernel (int8 tables marked
    by ``w_scale`` dequantize on the tile); other impls route frozen weights
    through the freq path and run the epilogue afterwards.
    """
    if impl == "pallas":
        from repro_torch.kernels.block_circulant import ops as bc_ops

        return bc_ops.block_circulant_matmul(
            x, w, bias=bias, activation=activation, w_freq=w_freq,
            w_scale=w_scale, k=k)
    if w_freq is not None:
        wr, wi = dequantize_freq_pair(*w_freq, w_scale)
        y = block_circulant_matvec_freq(x, w, w_freq=_as_complex(wr, wi),
                                        k=k)
    else:
        y = block_circulant_apply(x, w, impl=impl, karatsuba=karatsuba)
    return _epilogue(y, bias, activation)


def concat_biases(splits, biases, k: int) -> Optional[torch.Tensor]:
    """Stack per-projection biases along the fused p axis (None -> zeros)."""
    if biases is None or not any(b is not None for b in biases):
        return None
    dev = next(b for b in biases if b is not None).device
    parts = [(torch.zeros((p * k,), dtype=torch.float32, device=dev)
              if b is None else b.reshape(-1).float())
             for p, b in zip(splits, biases)]
    return torch.cat(parts)


def split_outputs(y: torch.Tensor, splits, k: int):
    """Slice a fused (..., Σp_i·k) output back into per-projection outputs."""
    outs = []
    off = 0
    for p in splits:
        outs.append(y[..., off: off + p * k])
        off += p * k
    return outs


def block_circulant_apply_multi(
    x: torch.Tensor,
    ws,
    *,
    impl: str = "freq",
    biases=None,
    activation: str = "none",
    w_freqs=None,
    w_freq_cat: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_scale_cat: Optional[torch.Tensor] = None,
    splits: Optional[Tuple[int, ...]] = None,
    bias_cat: Optional[torch.Tensor] = None,
    k: Optional[int] = None,
    karatsuba: bool = False,
):
    """N projections sharing one input -> one stacked-p launch, any impl.

    ``w_freq_cat=(wr, wi)`` takes the table already stacked along p (the
    ``_fused`` group ``plan.freeze_params`` attaches) with explicit
    ``splits`` and ``k``; ``bias_cat`` / ``w_scale_cat`` are its stacked
    bias and int8 scales. Returns the per-projection outputs.
    """
    if w_freq_cat is not None:
        if splits is None or k is None:
            raise ValueError("w_freq_cat needs explicit splits and k")
        if biases is not None:
            raise ValueError("w_freq_cat takes bias_cat, not per-proj biases")
    if impl == "pallas":
        from repro_torch.kernels.block_circulant import ops as bc_ops

        return bc_ops.block_circulant_matmul_multi(
            x, ws, biases=biases, activation=activation, w_freqs=w_freqs,
            w_freq_cat=w_freq_cat, w_scale_cat=w_scale_cat, splits=splits,
            bias_cat=bias_cat, k=k)
    if w_freq_cat is not None:
        wr, wi = dequantize_freq_pair(*w_freq_cat, w_scale_cat)
        y = block_circulant_matvec_freq(x, None, w_freq=_as_complex(wr, wi),
                                        k=k)
        if bias_cat is not None:
            y = y + bias_cat.to(y.dtype)
        return [_epilogue(o, None, activation)
                for o in split_outputs(y, list(splits), k)]
    if w_freqs is not None:
        ps = [wr.shape[0] for wr, _ in w_freqs]
        if k is None:
            k = (ws[0].shape[-1] if ws is not None
                 else 2 * (w_freqs[0][0].shape[-1] - 1))
        wf_cat = torch.cat([_as_complex(wr, wi) for wr, wi in w_freqs], 0)
        y = block_circulant_matvec_freq(x, None, w_freq=wf_cat, k=k)
    else:
        ps = [w.shape[0] for w in ws]
        k = ws[0].shape[-1]
        y = block_circulant_apply(x, torch.cat(list(ws), 0), impl=impl,
                                  karatsuba=karatsuba)
    return [_epilogue(o, biases[i] if biases is not None else None,
                      activation)
            for i, o in enumerate(split_outputs(y, ps, k))]


# ---------------------------------------------------------------------------
# FLOP accounting
# ---------------------------------------------------------------------------


def dense_flops(batch: int, m: int, n: int) -> int:
    return 2 * batch * m * n


def swm_flops(batch: int, m: int, n: int, k: int, impl: str = "freq") -> int:
    """Analytic FLOPs of one SWM layer application (forward): ~5k·log2 k
    per length-k transform, 8 per complex multiply-add of the contraction,
    one inverse transform per (i, j) block for ``paper``, per output block
    otherwise."""
    p, q, K = m // k, n // k, k // 2 + 1
    fft = 5 * k * int(np.log2(max(k, 2)))
    contraction = 8 * p * q * K
    iffts = p * q if impl == "paper" else p
    return batch * (q * fft + contraction + iffts * fft)
