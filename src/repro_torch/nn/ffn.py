"""Feed-forward blocks: SwiGLU (LM family) and GeLU MLP, SWM-aware.

Under tensor parallelism (``tp``, the ``model`` axis, set by
``dist.tensor_parallel.shard_model`` when ``mlp`` is split) ``wi``/``wu``
hold this rank's output blocks and ``wo`` its input blocks: x enters the
region once (its gradient summed over the axis) and ``wo`` sums the
partial outputs."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import SWMConfig
from repro_torch.core.circulant import block_circulant_apply_pair
from repro_torch.dist.sharding import region_input
from repro_torch.nn.linear import Linear

__all__ = ["SwiGLU", "MLP"]


class SwiGLU(nn.Module):
    """wo( silu(wi(x)) * wu(x) ) — llama/gemma/qwen FFN.

    ``expert_dims=(E,)`` holds E experts' tables stacked (a MoE layer's
    ``experts``): x (E, C, d) -> (E, C, d), expert e on rows x[e], as
    three grouped launches (wi, wu, wo) on the kernel impl.

    On the ``dft`` impl with both gate and up circulant at one block size,
    no expert axis and time-domain tables (not a frozen serve tree), the
    two take one shared forward DFT of x
    (``circulant.block_circulant_apply_pair``)."""

    def __init__(self, d_model: int, d_ff: int,
                 swm: Optional[SWMConfig] = None, family: str = "ffn",
                 dtype: str = "bfloat16", expert_dims: Tuple[int, ...] = ()):
        super().__init__()
        kw = dict(family=family, swm=swm, dtype=dtype,
                  expert_dims=expert_dims)
        up = dict(kw, in_axis="embed", out_axis="mlp")
        self.add_module("wi", Linear(d_model, d_ff, **up))
        self.add_module("wu", Linear(d_model, d_ff, **up))
        self.add_module("wo", Linear(d_ff, d_model, in_axis="mlp",
                                     out_axis="embed", **kw))
        self.tp = None

    def specs(self):
        return {n: self._modules[n].specs() for n in ("wi", "wu", "wo")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._modules
        x = region_input(x, self.tp)
        wi, wu = m["wi"], m["wu"]
        if (wi.is_circulant and wu.is_circulant
                and wi.block_size == wu.block_size
                and wi.swm.impl == "dft" and not wi.expert_dims
                and "w" in wi._buffers):
            gi, u = block_circulant_apply_pair(x, wi._buffers["w"],
                                               wu._buffers["w"])
        else:
            gi, u = wi(x), wu(x)
        return m["wo"](torch.nn.functional.silu(gi) * u)


class MLP(nn.Module):
    """wo(gelu(wi(x))) — classic 2-matrix FFN (tanh-approximate gelu, as
    the reference's ``jax.nn.gelu`` default)."""

    def __init__(self, d_model: int, d_ff: int,
                 swm: Optional[SWMConfig] = None, family: str = "ffn",
                 dtype: str = "bfloat16"):
        super().__init__()
        kw = dict(family=family, swm=swm, dtype=dtype)
        self.add_module("wi", Linear(d_model, d_ff, in_axis="embed",
                                     out_axis="mlp", **kw))
        self.add_module("wo", Linear(d_ff, d_model, in_axis="mlp",
                                     out_axis="embed", **kw))
        self.tp = None

    def specs(self):
        return {n: self._modules[n].specs() for n in ("wi", "wo")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = region_input(x, self.tp)
        h = torch.nn.functional.gelu(self._modules["wi"](x),
                                     approximate="tanh")
        return self._modules["wo"](h)
