"""Block-circulant CONV layer (paper §3, CirCNN).

The conv tensor F ∈ R^{r×r×C×P} is block-circulant over the channel dims:
for every spatial tap (i, j), the C×P matrix F(i, j, ·, ·) is cut into k×k
circulant blocks. The layer runs as an im2col GEMM whose weight is
block-circulant over channels: the (t, p, q, k) tap table reshapes to ONE
(p, r²·q, k) block table (every (tap, input block) pair is a circulant
block) and goes through ``kernels.block_circulant.ops.
block_circulant_matmul`` whatever the model's impl, as in the reference
(``repro/core/conv.py``): on the card every conv with k > 1 launches
``bc_matmul`` (bias fused into its epilogue), and training takes the
kernel-backed dx and dw adjoints. ``plan.freeze_params`` stores the frozen
tables in the (p, r²·q, K) layout already (the ``conv_taps`` tag), so a
frozen forward reshapes no weights and issues no rfft(w).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.circulant import valid_block_size
from repro_torch.kernels.block_circulant import ops as bc_ops
from repro_torch.nn.module import ParamSpec

__all__ = ["CirculantConv2D", "extract_patches"]


def extract_patches(x: torch.Tensor, r: int) -> torch.Tensor:
    """x (B, H, W, C) -> im2col patches (B, Ho, Wo, r·r, C), VALID padding.

    Two index gathers (rows, then columns); tap order is (i·r + j) with the
    row offset i major, the layout the tap-table reshape assumes. Values
    are copies, so they equal the reference's bit for bit; autograd
    scatters the patches' gradient back onto x.
    """
    B, H, W, C = x.shape
    if H < r or W < r:
        raise ValueError(
            f"conv input spatial dims ({H}, {W}) are smaller than "
            f"ksize={r}: VALID padding would produce empty output; pad the "
            f"input or reduce ksize")
    Ho, Wo = H - r + 1, W - r + 1
    taps = torch.arange(r, device=x.device)
    ri = taps[:, None] + torch.arange(Ho, device=x.device)[None, :]
    ci = taps[:, None] + torch.arange(Wo, device=x.device)[None, :]
    rows = x[:, ri]                              # (B, r, Ho, W, C)
    patches = rows[:, :, :, ci]                  # (B, r, Ho, r, Wo, C)
    patches = patches.permute(0, 2, 4, 1, 3, 5)  # (B, Ho, Wo, r, r, C)
    return patches.reshape(B, Ho, Wo, r * r, C)


class CirculantConv2D(nn.Module):
    """VALID conv ``(B, H, W, C) -> (B, H-r+1, W-r+1, P)``; block-circulant
    over channels when the block size k > 1, dense at k = 1. Holds ``w``
    and ``b`` (or the frozen ``wr``/``wi``[/``w_scale``] and ``b``) as
    buffers."""

    def __init__(self, in_ch: int, out_ch: int, ksize: int = 3,
                 block_size: int = 1, dtype: str = "float32"):
        super().__init__()
        self.in_ch, self.out_ch = int(in_ch), int(out_ch)
        self.ksize, self.block_size = int(ksize), int(block_size)
        self.dtype = dtype

    @property
    def k(self) -> int:
        if self.block_size <= 1:
            return 1
        return valid_block_size(self.block_size, self.in_ch, self.out_ch)

    def specs(self):
        r, C, P, k = self.ksize, self.in_ch, self.out_ch, self.k
        std = (r * r * C) ** -0.5
        if k > 1:
            # "circulant" lets plan.freeze_params swap the tap table for
            # its frozen rfft; "conv_taps" stores it in the (p, r²·q, K)
            # im2col layout
            w = ParamSpec((r * r, P // k, C // k, k), self.dtype, scale=std,
                          tags=("circulant", "conv_taps"),
                          axes=(None, None, None, None))
        else:
            w = ParamSpec((r * r, C, P), self.dtype, scale=std,
                          axes=(None, None, None))
        return {"w": w, "b": ParamSpec((P,), "float32", init="zeros",
                                       axes=(None,))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, C, P, k = self.ksize, self.in_ch, self.out_ch, self.k
        buf = self._buffers
        B = x.shape[0]
        patches = extract_patches(x, r)           # (B, Ho, Wo, r·r, C)
        Ho, Wo = patches.shape[1], patches.shape[2]
        if k == 1:
            y = torch.einsum("bhwtc,tcp->bhwp", patches, buf["w"].to(x.dtype))
            return y + buf["b"].to(y.dtype)
        p, q = P // k, C // k
        x2d = patches.reshape(B * Ho * Wo, r * r * C)
        w_bc, w_freq, w_scale = None, None, None
        if "wr" in buf and "wi" in buf:
            # frozen: already in the (p, r²·q, K) layout
            w_freq = (buf["wr"], buf["wi"])
            w_scale = buf.get("w_scale")
        else:
            # (t, p, q, k) tap table -> ONE (p, r²·q, k) block table whose
            # block index is t·q + j, matching the patches' (t, c) layout
            w_bc = buf["w"].permute(1, 0, 2, 3).reshape(p, r * r * q, k)
        y = bc_ops.block_circulant_matmul(
            x2d, w_bc, bias=buf["b"], w_freq=w_freq, w_scale=w_scale, k=k,
            q=r * r * q)
        return y.reshape(B, Ho, Wo, P)
