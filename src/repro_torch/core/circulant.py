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
    "block_circulant_apply",
    "block_circulant_apply_fused",
    "block_circulant_apply_multi",
    "dequantize_freq_pair",
    "concat_biases",
    "split_outputs",
    "dft_bases",
    "dft_bases_adjoint",
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
# Unified entry points
# ---------------------------------------------------------------------------


def block_circulant_apply(x: torch.Tensor, w: torch.Tensor, *,
                          impl: str = "freq") -> torch.Tensor:
    """Dispatch on implementation. x (..., q·k), w (p, q, k) -> (..., p·k)."""
    if impl == "paper":
        return block_circulant_matvec_paper(x, w)
    if impl == "freq":
        return block_circulant_matvec_freq(x, w)
    if impl == "pallas":
        from repro_torch.kernels.block_circulant import ops as bc_ops

        return bc_ops.block_circulant_matmul(x, w)
    raise NotImplementedError(f"impl {impl!r} is not ported yet")


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
        y = block_circulant_apply(x, w, impl=impl)
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
        y = block_circulant_apply(x, torch.cat(list(ws), 0), impl=impl)
    return [_epilogue(o, biases[i] if biases is not None else None,
                      activation)
            for i, o in enumerate(split_outputs(y, ps, k))]
