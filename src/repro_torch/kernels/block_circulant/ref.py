"""Dense oracle for the block-circulant matmul kernel: expand every k×k
circulant block and do an ordinary GEMM. O(B·m·n) — test-only."""

from __future__ import annotations

import torch

from repro_torch.core.circulant import blocks_to_dense

__all__ = ["block_circulant_matmul_ref", "blocks_to_dense"]


def block_circulant_matmul_ref(x: torch.Tensor, w: torch.Tensor
                               ) -> torch.Tensor:
    """x (..., q·k) @ BlockCirculant(w)^T -> (..., p·k), computed densely."""
    W = blocks_to_dense(w.float())
    return (x.float() @ W.T).to(x.dtype)
