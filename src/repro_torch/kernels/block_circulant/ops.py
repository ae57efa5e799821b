"""Public ops: block-circulant matmuls backed by the CUDA kernel (forward).

``block_circulant_matmul(x, w)``: x (..., q·k) × blocks w (p, q, k)
-> (..., p·k), with an optional fused epilogue (bias add + activation) and
an optional frozen frequency-weight path (``w_freq=(wr, wi)``) that skips
the per-call ``rfft(w)`` — the paper's resident FFT(w) inference path.
``w_scale`` marks frozen int8 tables dequantized inside the kernel.

``block_circulant_matmul_multi`` stacks several projections that share one
input (attention QKV, LSTM gates) along p and runs them as one launch.

The kernel masks ragged edges itself, so nothing here pads. The autograd
Functions of the reference's custom VJPs arrive with the training slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.circulant import concat_biases, split_outputs
from repro_torch.kernels.block_circulant.kernel import bc_matmul

__all__ = ["block_circulant_matmul", "block_circulant_matmul_multi",
           "freq_weights", "freq_weights_trace_count"]

# Counts every rfft(w) issued. Serving freezes weights exactly once, so the
# tests assert this does not move across an engine's lifetime after freeze.
_FREQ_WEIGHT_CALLS = 0


def freq_weights_trace_count() -> int:
    """Process-wide count of ``freq_weights`` calls (rfft(w) work)."""
    return _FREQ_WEIGHT_CALLS


def freq_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-domain block table (..., p, q, k) -> contiguous f32 (wr, wi)
    real/imag rfft. Leading stack dims pass through."""
    global _FREQ_WEIGHT_CALLS
    _FREQ_WEIGHT_CALLS += 1
    wf = torch.fft.rfft(w.float(), dim=-1)
    return wf.real.contiguous(), wf.imag.contiguous()


def block_circulant_matmul(
    x: torch.Tensor,
    w: Optional[torch.Tensor],
    *,
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    w_freq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_scale: Optional[torch.Tensor] = None,
    k: Optional[int] = None,
) -> torch.Tensor:
    """Block-circulant matmul; arbitrary leading batch dims.

    ``bias`` (p·k,) and ``activation`` fuse into the kernel epilogue.
    ``w_freq=(wr, wi)`` (p, q, K) selects the frozen path; pass ``k`` with
    it when w is None (K alone is ambiguous for odd k). ``w_scale`` (p, q)
    f32 marks int8 frozen tables.
    """
    if w_scale is not None and w_freq is None:
        raise ValueError("w_scale only applies to frozen w_freq tables")
    if w_freq is not None:
        wr, wi = w_freq
        p, q = wr.shape[0], wr.shape[1]
        if k is None:
            k = 2 * (wr.shape[-1] - 1) if w is None else w.shape[-1]
    else:
        p, q, k = w.shape
    if x.shape[-1] != q * k:
        raise ValueError(
            f"x feature dim {x.shape[-1]} is incompatible with block "
            f"tables (q={q}, k={k}): expected exactly q*k={q * k}")
    if w_freq is None:
        wr, wi = freq_weights(w)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    b = None if bias is None else bias.reshape(-1).float().contiguous()
    y = bc_matmul(x2d, wr, wi, b, w_scale, k=int(k), activation=activation)
    return y.reshape(*lead, p * k)


def block_circulant_matmul_multi(
    x: torch.Tensor,
    ws: Optional[Sequence[torch.Tensor]],
    *,
    biases: Optional[Sequence[Optional[torch.Tensor]]] = None,
    activation: str = "none",
    w_freqs: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    w_freq_cat: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_scale_cat: Optional[torch.Tensor] = None,
    splits: Optional[Sequence[int]] = None,
    bias_cat: Optional[torch.Tensor] = None,
    k: Optional[int] = None,
) -> List[torch.Tensor]:
    """N projections sharing one input -> ONE stacked-p kernel launch.

    All tables share (q, k); outputs are split back per projection.
    ``w_freq_cat=(wr, wi)`` + ``splits`` + ``k`` (optionally ``bias_cat``
    and int8 ``w_scale_cat``) take the table already stacked, as
    ``plan.freeze_params`` builds it.
    """
    if w_scale_cat is not None and w_freq_cat is None:
        raise ValueError("w_scale_cat only applies to w_freq_cat tables")
    if w_freq_cat is not None:
        if splits is None or k is None:
            raise ValueError("w_freq_cat needs explicit splits and k")
        if biases is not None:
            raise ValueError("w_freq_cat takes bias_cat, not per-proj biases")
        y = block_circulant_matmul(
            x, None, bias=bias_cat, activation=activation,
            w_freq=w_freq_cat, w_scale=w_scale_cat, k=k)
        return split_outputs(y, [int(p) for p in splits], k)
    if w_freqs is not None:
        ps = [wr.shape[0] for wr, _ in w_freqs]
        if k is None:
            k = (ws[0].shape[-1] if ws is not None
                 else 2 * (w_freqs[0][0].shape[-1] - 1))
        w_cat = None
        wf_cat = (torch.cat([wr for wr, _ in w_freqs], 0),
                  torch.cat([wi for _, wi in w_freqs], 0))
    else:
        ps = [w.shape[0] for w in ws]
        k = ws[0].shape[-1]
        w_cat = torch.cat(list(ws), 0)
        wf_cat = None
    y = block_circulant_matmul(
        x, w_cat, bias=concat_biases(ps, biases, k), activation=activation,
        w_freq=wf_cat, k=k)
    return split_outputs(y, ps, k)
