"""Linear projections — dense or block-circulant (SWM), one API.

When the layer's family is in ``swm.targets`` and the dims admit a block
size > 1, the parameter is the (p, q, k) circulant block table ``w``
instead of the (in, out) dense kernel. After ``plan.freeze_params`` the
module holds the frozen frequency tables ``wr``/``wi`` (and int8
``w_scale``) instead, and takes the no-rfft path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import SWMConfig
from repro_torch.core import circulant as circ
from repro_torch.kernels.block_circulant.kernel import apply_activation
from repro_torch.nn.module import ParamSpec

__all__ = ["Linear"]


class Linear(nn.Module):
    """A projection ``(..., in_dim) -> (..., out_dim)``.

    family: 'attn' | 'ffn' | ... — decides SWM applicability.
    """

    def __init__(self, in_dim: int, out_dim: int, *, family: str = "ffn",
                 swm: Optional[SWMConfig] = None, dtype: str = "bfloat16"):
        super().__init__()
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.family = family
        self.swm = swm if swm is not None else SWMConfig()
        self.dtype = dtype

    @property
    def block_size(self) -> int:
        if not self.swm.applies_to(self.family):
            return 1
        return circ.valid_block_size(self.swm.block_size, self.in_dim,
                                     self.out_dim)

    @property
    def is_circulant(self) -> bool:
        return self.block_size > 1

    def specs(self):
        k = self.block_size
        # variance-preserving init: var(w) = 1/in_dim on both layouts
        std = self.in_dim ** -0.5
        if k > 1:
            p, q = self.out_dim // k, self.in_dim // k
            w = ParamSpec((p, q, k), self.dtype, scale=std,
                          tags=("circulant",))
        else:
            w = ParamSpec((self.in_dim, self.out_dim), self.dtype, scale=std)
        return {"w": w}

    def frozen_freq(self):
        """(wr, wi) when frozen frequency weights are attached, else None."""
        b = self._buffers
        if self.is_circulant and "wr" in b and "wi" in b:
            return (b["wr"], b["wi"])
        return None

    def frozen_scale(self) -> Optional[torch.Tensor]:
        """Per-block int8 scales when the frozen tables are quantized."""
        if self.is_circulant and "wr" in self._buffers:
            return self._buffers.get("w_scale")
        return None

    def forward(self, x: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
                activation: str = "none") -> torch.Tensor:
        """Apply; ``bias``/``activation`` are the fused kernel epilogue on
        the circulant path."""
        if self.is_circulant:
            return circ.block_circulant_apply_fused(
                x, self._buffers.get("w"), impl=self.swm.impl, bias=bias,
                activation=activation, w_freq=self.frozen_freq(),
                w_scale=self.frozen_scale(), k=self.block_size)
        y = x @ self._buffers["w"].to(x.dtype)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return apply_activation(y, activation)
