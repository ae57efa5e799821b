"""Public ops: differentiable block-circulant matmuls backed by the kernels.

``block_circulant_matmul(x, w)``: x (..., q·k) × blocks w (p, q, k)
-> (..., p·k), with an optional fused epilogue (bias add + activation) and
an optional frozen frequency-weight path (``w_freq=(wr, wi)``) that skips
the per-call ``rfft(w)`` — the paper's resident FFT(w) inference path.
``w_scale`` marks frozen int8 tables dequantized inside the kernel.

``block_circulant_matmul_multi`` stacks several projections that share one
input (attention QKV, LSTM gates) along p and runs them as one launch.

Stacked tables (a leading group axis: a MoE layer's experts, ``(G, p, q,
k)`` or frozen ``(G, p, q, K)``) take x ``(G, ..., q·k)`` and run all G
products in one grouped kernel launch, the reference's kernel under
``jax.vmap``; under autograd the same Functions carry the group axis
through their backward (one grouped ``bc_matmul`` for dx, one grouped
``bc_dw`` for dw), the reference's custom VJPs under ``jax.vmap``.

Gradients are the reference's closed-form circulant adjoints
(``repro/kernels/block_circulant/ops.py``), as ``torch.autograd.Function``s
whose backward launches the kernels on the card and runs their plain
versions on the CPU:

* dL/dx = g @ W reuses the forward kernel ``bc_matmul`` on the transposed
  tables (a circulant transpose is the index-reversed vector, conj(ŵ) in
  the frequency domain; the block grid transposes p ↔ q);
* dL/dw is the weight-adjoint kernel ``bc_dw``: folded back to the time
  domain for a trainable table ``w`` (``_BCMatmul2d``), the raw frequency
  pair for trainable frozen tables (``_BCFreq2d``);
* the forward's (wr, wi) are saved, so the backward never re-transforms w.

Under autograd the activation runs unfused after a ``"none"`` launch, so
the pre-activation is what the activation's own backward reads; a call
that records no gradient stays fully fused. The int8 path is primal-only,
as in the reference: differentiating through it raises. The kernels mask
ragged edges themselves, so nothing here pads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.circulant import (concat_biases, dft_bases,
                                        split_outputs)
from repro_torch.kernels.block_circulant.kernel import (apply_activation,
                                                        bc_dw, bc_matmul)

__all__ = ["block_circulant_matmul", "block_circulant_matmul_multi",
           "count_kernel_launches", "freq_weights",
           "freq_weights_trace_count", "outer_mm_shapes"]


# ---------------------------------------------------------------------------
# Structural probes over a capture (``analysis.walker.capture``), the
# counterparts of the reference's jaxpr probes: the "no dense (P, Q)
# contraction in the train step" checks inspect what ran, not numerics
# ---------------------------------------------------------------------------


def outer_mm_shapes(trace) -> List[Tuple[int, ...]]:
    """Output shapes of every dense contraction (``aten.mm``, ``bmm``,
    ...) OUTSIDE the kernel ops: a kernel op is one record of the capture,
    so the contractions of its plain version never appear. A regression
    test asserts that none of them spans a circulant layer's (P, Q) block
    grid (the signature of an einsum weight adjoint)."""
    from repro_torch.analysis.rules import DOT_OPS

    return [shape for op in trace if op.name in DOT_OPS
            for shape in op.out_shapes]


def count_kernel_launches(trace) -> int:
    """Number of kernel ops (``bc_matmul``, ``bc_dw``, ``bc_dw_freq``) in
    a capture: one launch each."""
    from repro_torch.analysis.rules import LAUNCH_OPS

    return sum(1 for op in trace if op.name in LAUNCH_OPS)

# Counts every rfft(w) issued. Serving freezes weights exactly once, so the
# tests assert this does not move across an engine's lifetime after freeze;
# a train step issues one per forward (the backward reuses it).
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


# ---------------------------------------------------------------------------
# Closed-form adjoints
# ---------------------------------------------------------------------------


def _transpose_freq(wr: torch.Tensor, wi: torch.Tensor):
    """Frequency tables of the transposed block-circulant matrix:
    (Wᵀ)_ji = W_ijᵀ, and a circulant transpose is conj(ŵ) — swap (p, q),
    negate wi; a leading group axis passes through. Contiguous, as the
    kernel takes them."""
    return (wr.transpose(-3, -2).contiguous(),
            (-wi).transpose(-3, -2).contiguous())


def _dx_via_kernel(gz: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                   k: int) -> torch.Tensor:
    """dx = gz @ W through the forward kernel on the transposed tables;
    gz ([G,] B, p·k) -> ([G,] B, q·k) in gz's dtype."""
    wrT, wiT = _transpose_freq(wr, wi)
    return bc_matmul(gz.contiguous(), wrT, wiT, k=k)


def _dw_via_kernel(x2d: torch.Tensor, gz: torch.Tensor, P: int, Q: int,
                   k: int, freq_out: bool = False):
    """Weight adjoint through the ``bc_dw`` kernel: time-domain ``dw
    ([G,] P, Q, k)`` f32, or the frequency cotangents ``(dwr, dwi)`` each
    ([G,] P, Q, K) f32 when ``freq_out``."""
    out = bc_dw(x2d.contiguous(), gz.contiguous(), P=P, Q=Q, k=k,
                freq_out=freq_out)
    return out if freq_out else out.reshape(out.shape[:-1] + (Q, k))


def _dw_freq_cotangents(x2d, gz, P, Q, k):
    """(dwr, dwi) frequency cotangents of the per-bin complex GEMM as
    einsums — the oracle :func:`_dw_via_kernel` is tested against (test
    use only)."""
    C, S, Ci, Si = dft_bases(k, device=x2d.device)
    xb = x2d.float().reshape(-1, Q, k)
    xr, xi = xb @ C, xb @ S
    gb = gz.float().reshape(-1, P, k)
    # adjoint of the inverse rDFT (y = yr@Ci + yi@Si)
    gyr, gyi = gb @ Ci.T, gb @ Si.T
    dwr = (torch.einsum("bpf,bqf->pqf", gyr, xr)
           + torch.einsum("bpf,bqf->pqf", gyi, xi))
    dwi = (-torch.einsum("bpf,bqf->pqf", gyr, xi)
           + torch.einsum("bpf,bqf->pqf", gyi, xr))
    return dwr, dwi


def _bias_grad(gz: torch.Tensor) -> torch.Tensor:
    """Each group's row sum: ([G,] B, p·k) -> ([G,] p·k) f32."""
    return gz.sum(-2).to(torch.float32)


class _BCMatmul2d(torch.autograd.Function):
    """Trainable time-domain table ``w (p, q, k)``: the reference's
    ``_bc_matmul2d`` custom VJP. Returns the pre-activation
    ``z = x @ W + bias`` in x's dtype. Stacked tables ``w (G, p, q, k)``
    with x (G, B, q·k) and bias (G, p·k) run every launch grouped: the
    custom VJP under ``jax.vmap``."""

    @staticmethod
    def forward(ctx, x2d, w, bias):
        k = w.shape[-1]
        wr, wi = freq_weights(w)
        z = bc_matmul(x2d, wr, wi, bias, k=k)
        # saved after the launch: a recomputing checkpoint may stop at the
        # last save, and the launch belongs to the recomputed forward
        ctx.save_for_backward(x2d, wr, wi)
        ctx.w_dtype = w.dtype
        return z

    @staticmethod
    def backward(ctx, gz):
        x2d, wr, wi = ctx.saved_tensors
        p, q, _ = wr.shape[-3:]
        k = x2d.shape[-1] // q
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _dx_via_kernel(gz, wr, wi, k).to(x2d.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw_via_kernel(x2d, gz, p, q, k).to(ctx.w_dtype)
        if ctx.needs_input_grad[2]:
            db = _bias_grad(gz)
        return dx, dw, db


class _BCFreq2d(torch.autograd.Function):
    """Trainable frozen tables ``(wr, wi) (p, q, K)``: the reference's
    ``_bc_freq2d`` custom VJP. Returns the pre-activation in x's dtype.
    Stacked ``(G, p, q, K)`` tables run grouped, as in :class:`_BCMatmul2d`."""

    @staticmethod
    def forward(ctx, x2d, wr, wi, bias, k):
        z = bc_matmul(x2d, wr, wi, bias, k=k)
        ctx.save_for_backward(x2d, wr, wi)
        ctx.k = k
        return z

    @staticmethod
    def backward(ctx, gz):
        x2d, wr, wi = ctx.saved_tensors
        p, q, _ = wr.shape[-3:]
        k = ctx.k
        dx = dwr = dwi = db = None
        if ctx.needs_input_grad[0]:
            dx = _dx_via_kernel(gz, wr, wi, k).to(x2d.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dwr, dwi = _dw_via_kernel(x2d, gz, p, q, k, freq_out=True)
            dwr, dwi = dwr.to(wr.dtype), dwi.to(wi.dtype)
        if ctx.needs_input_grad[3]:
            db = _bias_grad(gz)
        return dx, dwr, dwi, db, None


class _BCFreqQuant2d(torch.autograd.Function):
    """int8 frozen tables, single or stacked: primal-only, as the
    reference's ``_bc_freq_quant2d`` (``jax.grad`` through it raises). The
    forward is the fused launch; any gradient through it raises instead of
    coming back silently zero."""

    @staticmethod
    def forward(ctx, x2d, wr, wi, w_scale, bias, k, activation):
        return bc_matmul(x2d, wr, wi, bias, w_scale, k=k,
                         activation=activation)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the int8 frozen-table path carries no gradient (primal-only, "
            "as the reference's _bc_freq_quant2d); train through f32 "
            "tables")


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def block_circulant_matmul(
    x: torch.Tensor,
    w: Optional[torch.Tensor],
    *,
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    w_freq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_scale: Optional[torch.Tensor] = None,
    k: Optional[int] = None,
    q: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable block-circulant matmul; arbitrary leading batch dims.

    ``bias`` (p·k,) and ``activation`` fuse into the kernel epilogue.
    ``w_freq=(wr, wi)`` (p, q, K) selects the frozen path; pass ``k`` with
    it when w is None (K alone is ambiguous for odd k). ``w_scale`` (p, q)
    f32 marks int8 frozen tables. ``q``, the number of input blocks, is
    checked against the tables: the port stores them unpadded, so it must
    equal their q (the reference also takes a smaller q for tile-padded
    plan tables, which the port does not have). Stacked tables (G, p, q,
    ·) with ``w_scale`` (G, p, q) and ``bias`` (G, p·k) take x (G, ...,
    q·k): every launch grouped, forward and backward.
    """
    if w_scale is not None and w_freq is None:
        raise ValueError("w_scale only applies to frozen w_freq tables")
    if w_freq is not None:
        wr, wi = w_freq
        p, tq = wr.shape[-3], wr.shape[-2]
        if k is None:
            k = 2 * (wr.shape[-1] - 1) if w is None else w.shape[-1]
    else:
        p, tq, k = w.shape[-3:]
    if q is not None and int(q) != tq:
        raise ValueError(
            f"q={q} but the tables hold {tq} input blocks: the port's "
            f"tables are unpadded, so q must equal their q")
    q = tq
    if x.shape[-1] != q * k:
        raise ValueError(
            f"x feature dim {x.shape[-1]} is incompatible with block "
            f"tables (q={q}, k={k}): expected exactly q*k={q * k}")
    k = int(k)
    # stacked tables: the group axis leads x, the bias and every launch
    table = w_freq[0] if w_freq is not None else w
    groups = table.shape[:1] if table.dim() == 4 else ()
    if groups and (x.dim() < 2 or x.shape[0] != groups[0]):
        raise ValueError(f"x {tuple(x.shape)} must lead with the tables' "
                         f"{groups[0]} groups")
    x2d = x.reshape(*groups, -1, x.shape[-1]).contiguous()
    b = (None if bias is None
         else bias.reshape(*groups, -1).float().contiguous())
    if not _records_grad(x, w, b, w_scale, *(w_freq or ())):
        if w_freq is None:
            wr, wi = freq_weights(w)
        y = bc_matmul(x2d, wr, wi, b, w_scale, k=k, activation=activation)
    elif w_scale is not None:
        y = _BCFreqQuant2d.apply(x2d, wr, wi, w_scale, b, k, activation)
    else:
        z = (_BCMatmul2d.apply(x2d, w, b) if w_freq is None
             else _BCFreq2d.apply(x2d, wr, wi, b, k))
        y = apply_activation(z, activation).to(x.dtype)
    return y.reshape(*x.shape[:-1], p * k)


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
