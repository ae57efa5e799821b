"""Linear projections — dense or block-circulant (SWM), one API.

When the layer's family is in ``swm.targets`` and the dims admit a block
size > 1, the parameter is the (p, q, k) circulant block table ``w``
instead of the (in, out) dense kernel. After ``plan.freeze_params`` the
module holds the frozen frequency tables ``wr``/``wi`` (and int8
``w_scale``) instead, and takes the no-rfft path.

``expert_dims=(E,)`` stacks E projections of one shape (a MoE layer's
experts): every table gains a leading ``E`` axis and the forward maps x
``(E, ..., in)`` to ``(E, ..., out)``, expert e through table e. On the
kernel impl that is one grouped launch; other impls and dense experts run
the same per-expert math the reference's ``jax.vmap`` does.

Under tensor parallelism (``dist.tensor_parallel.shard_model``) the layer
holds this rank's slice of its table: the ``p`` output blocks of a
column-parallel layer (its caller enters the sharded region) or the ``q``
input blocks of a row-parallel one (``parallel == "row"``), whose partial
outputs are summed over the ``model`` axis before the bias and the
activation are applied once: the fused epilogue never runs on a partial
sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import SWMConfig
from repro_torch.core import circulant as circ
from repro_torch.kernels.block_circulant.kernel import apply_activation
from repro_torch.nn.module import ParamSpec

__all__ = ["Linear"]


class Linear(nn.Module):
    """A projection ``(..., in_dim) -> (..., out_dim)``.

    family: 'attn' | 'ffn' | 'expert' | 'router' | 'head' | ... — decides
    SWM applicability. expert_dims: leading expert axes, () or (E,).
    in_axis/out_axis: logical sharding axis names. A circulant table
    ``(p, q, k)`` carries them on its (p, q) dims, as the dense kernel
    ``(in, out)`` does, so the sharding rules treat both alike; expert axes
    are ``"experts"``.
    """

    def __init__(self, in_dim: int, out_dim: int, *, family: str = "ffn",
                 swm: Optional[SWMConfig] = None, dtype: str = "bfloat16",
                 expert_dims: Tuple[int, ...] = (),
                 in_axis: Optional[str] = None,
                 out_axis: Optional[str] = None):
        super().__init__()
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.in_axis, self.out_axis = in_axis, out_axis
        self.family = family
        self.swm = swm if swm is not None else SWMConfig()
        self.dtype = dtype
        self.expert_dims = tuple(int(e) for e in expert_dims)
        if len(self.expert_dims) > 1:
            raise ValueError(f"expert_dims {expert_dims}: one expert axis "
                             f"at most")
        # tensor parallelism: "row" sums the partial outputs over ``tp``
        self.parallel, self.tp = None, None

    @property
    def block_size(self) -> int:
        if not self.swm.applies_to(self.family):
            return 1
        return circ.valid_block_size(self.swm.block_size, self.in_dim,
                                     self.out_dim)

    @property
    def is_circulant(self) -> bool:
        return self.block_size > 1

    @property
    def n_params(self) -> int:
        """Stored weights: in·out/k circulant, in·out dense (per expert,
        times the experts)."""
        k = self.block_size
        n = self.in_dim * self.out_dim // k
        for e in self.expert_dims:
            n *= e
        return n

    def specs(self):
        k = self.block_size
        lead = self.expert_dims
        lead_axes = ("experts",) * len(lead)
        # variance-preserving init: var(w) = 1/in_dim on both layouts
        std = self.in_dim ** -0.5
        if k > 1:
            p, q = self.out_dim // k, self.in_dim // k
            w = ParamSpec(lead + (p, q, k), self.dtype, scale=std,
                          tags=("circulant",),
                          axes=lead_axes + (self.out_axis, self.in_axis,
                                            None))
        else:
            w = ParamSpec(lead + (self.in_dim, self.out_dim), self.dtype,
                          scale=std,
                          axes=lead_axes + (self.in_axis, self.out_axis))
        return {"w": w}

    def frozen_freq(self, params=None):
        """(wr, wi) when frozen frequency weights are attached, else None."""
        b = self._buffers if params is None else params
        if self.is_circulant and "wr" in b and "wi" in b:
            return (b["wr"], b["wi"])
        return None

    def frozen_scale(self, params=None) -> Optional[torch.Tensor]:
        """Per-block int8 scales when the frozen tables are quantized."""
        b = self._buffers if params is None else params
        if self.is_circulant and "wr" in b:
            return b.get("w_scale")
        return None

    def forward(self, x: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
                activation: str = "none", params=None) -> torch.Tensor:
        """Apply; ``bias``/``activation`` are the fused kernel epilogue on
        the circulant path. ``params`` (a dict keyed like the buffers)
        takes the place of the module's own tensors for this call, as the
        reference's ``Linear(params, x)`` does (the paper models apply
        fixed-point copies of their tables this way)."""
        b = self._buffers if params is None else params
        if self.parallel == "row":
            from repro_torch.dist.sharding import region_output

            y = region_output(self._apply(x, b, None, "none"), self.tp)
            if bias is not None:
                y = y + bias.to(y.dtype)
            return apply_activation(y, activation)
        return self._apply(x, b, bias, activation)

    def _apply(self, x, b, bias, activation):
        if self.is_circulant:
            if self.expert_dims and self.swm.impl != "pallas":
                return self._per_expert(x, b, bias, activation)
            return circ.block_circulant_apply_fused(
                x, b.get("w"), impl=self.swm.impl, bias=bias,
                activation=activation, w_freq=self.frozen_freq(b),
                w_scale=self.frozen_scale(b), k=self.block_size,
                karatsuba=self.swm.karatsuba)
        w = b["w"].to(x.dtype)
        if self.expert_dims:       # x (E, ..., in) @ w (E, in, out)
            w = w.reshape(w.shape[:1] + (1,) * (x.dim() - 3) + w.shape[1:])
        y = x @ w
        if bias is not None:
            y = y + bias.to(y.dtype)
        return apply_activation(y, activation)

    def _per_expert(self, x, b, bias, activation):
        """Stacked circulant tables on an impl without a grouped launch:
        expert e's slice through the single-projection path, stacked."""
        def pick(t, e):
            return None if t is None else t[e]

        wf, sc = self.frozen_freq(b), self.frozen_scale(b)
        return torch.stack([
            circ.block_circulant_apply_fused(
                x[e], pick(b.get("w"), e), impl=self.swm.impl,
                bias=pick(bias, e), activation=activation,
                w_freq=None if wf is None else (wf[0][e], wf[1][e]),
                w_scale=pick(sc, e), k=self.block_size,
                karatsuba=self.swm.karatsuba)
            for e in range(x.shape[0])])
