"""Mamba (selective SSM) block — the jamba hybrid's attention-free mixer.

The reference's ``repro.nn.ssm.Mamba``: the in/out projections are
circulant-compressible (family ``ffn``, so they run the ``bc_matmul``
kernel on the kernel impl); ``x_proj``/``dt_proj`` (family
``mamba_inner``) stay dense, and the selective scan is not a weight matrix
and stays in plain PyTorch, as the reference left it to XLA. Decode carries
``{conv window, ssm state}`` per slot: O(1) per token.

Under tensor parallelism (``tp``, a ``dist.tensor_parallel.MambaLayout``
set by ``shard_model`` when ``mlp`` is split over ``model``) the rank holds
one range of the ``d_inner`` channels: x enters the region, ``in_proj``'s
output (the rule's contiguous cut of both halves) is all-gathered and the
rank takes its channels of ``xi`` and ``z``; the conv, the scan and the
gate run on those channels, with the cache's states cut to them;
``x_proj``'s partial outputs are summed forward and, because every rank's
channels read the sum, its gradient is summed backward too; ``out_proj``
sums the partial outputs into the residual.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import gather_along, region_input
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.scan import chunked_time_scan

__all__ = ["Mamba", "init_mamba_cache"]


def init_mamba_cache(batch: int, d_inner: int, d_state: int, d_conv: int,
                     dtype, device):
    """Empty state: the causal conv's last ``d_conv - 1`` inputs and the
    f32 SSM state, slot axis 0."""
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                           device=device),
    }


class Mamba(nn.Module):
    """x (B, S, d) -> y (B, S, d); the cache, when given, is updated in
    place."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        di, ds = self.d_inner, cfg.mamba_d_state
        kw = dict(swm=cfg.swm, dtype=cfg.param_dtype)
        self.add_module("in_proj", Linear(cfg.d_model, 2 * di, family="ffn",
                                          in_axis="embed", out_axis="mlp",
                                          **kw))
        self.add_module("x_proj", Linear(di, self.dt_rank + 2 * ds,
                                         family="mamba_inner", in_axis="mlp",
                                         **kw))
        self.add_module("dt_proj", Linear(self.dt_rank, di,
                                          family="mamba_inner",
                                          out_axis="mlp", **kw))
        self.add_module("out_proj", Linear(di, cfg.d_model, family="ffn",
                                           in_axis="mlp", out_axis="embed",
                                           **kw))
        self.tp = None

    @property
    def d_inner(self) -> int:
        return self.cfg.mamba_expand * self.cfg.d_model

    @property
    def dt_rank(self) -> int:
        return self.cfg.mamba_dt_rank or max(1, self.cfg.d_model // 16)

    def specs(self):
        cfg = self.cfg
        di, ds, dc = self.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        f32 = torch.float32
        m = self._modules
        return {
            "in_proj": m["in_proj"].specs(),
            "x_proj": m["x_proj"].specs(),
            "dt_proj": m["dt_proj"].specs(),
            "dt_bias": ParamSpec((di,), f32, init="zeros", axes=("mlp",)),
            "out_proj": m["out_proj"].specs(),
            "conv_w": ParamSpec((dc, di), cfg.param_dtype, init="normal",
                                scale=dc ** -0.5, axes=(None, "mlp")),
            "conv_b": ParamSpec((di,), f32, init="zeros", axes=("mlp",)),
            "A_log": ParamSpec((di, ds), f32, init="mamba_a_log",
                               axes=("mlp", None)),
            "D": ParamSpec((di,), f32, init="ones", axes=("mlp",)),
        }

    def _conv(self, x: torch.Tensor, conv_state: Optional[torch.Tensor]):
        """Causal depthwise conv over time, x (B, S, di) -> (out, the new
        window state)."""
        b = self._buffers
        dc = self.cfg.mamba_d_conv
        w = b["conv_w"].to(x.dtype)                         # (dc, di)
        if conv_state is None:
            pad = torch.zeros((x.shape[0], dc - 1, x.shape[2]),
                              dtype=x.dtype, device=x.device)
        else:
            pad = conv_state.to(x.dtype)
        xp = torch.cat([pad, x], dim=1)                     # (B, S+dc-1, di)
        out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(dc)) \
            + b["conv_b"].to(x.dtype)
        return out, xp[:, -(dc - 1):, :]

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                mask: Optional[torch.Tensor] = None):
        """``mask`` (B, S) bool marks valid (non-pad) positions. Pad lanes
        contribute exactly nothing: their conv input is zeroed *before* the
        causal window (so a left-padded window equals the zero padding of
        a fresh unpadded run) and the SSM state skips their steps, decay
        included. ``mask=None`` is the unmasked path. Returns (y, cache)."""
        cfg = self.cfg
        m, b = self._modules, self._buffers
        B, S, _ = x.shape
        di, ds = self.d_inner, cfg.mamba_d_state
        axis = None if self.tp is None else self.tp.axis

        xz = m["in_proj"](region_input(x, axis))
        if self.tp is None:
            xi, z = xz.chunk(2, dim=-1)                      # (B, S, di) each
        else:
            # the reference splits the global (B, S, 2 di): gather the
            # rank's cut, take its channels of each half
            xz = gather_along(xz, axis, -1)
            c0, c1 = self.tp.channels
            xi, z = xz[..., c0:c1], xz[..., di + c0:di + c1]
        if mask is not None:
            xi = torch.where(mask[..., None], xi, torch.zeros_like(xi))
        xi, new_conv = self._conv(xi, None if cache is None
                                  else cache["conv"])
        xi = F.silu(xi)

        # row-parallel: summed forward, and its gradient summed backward
        # (every rank's channels read the sum)
        xdb = region_input(m["x_proj"](xi), axis).float()
        dt, Bc, Cc = torch.split(xdb, [self.dt_rank, ds, ds], dim=-1)
        dt = F.softplus(m["dt_proj"](dt.to(x.dtype)).float() + b["dt_bias"])
        A = -torch.exp(b["A_log"])                           # (di, ds)
        xf = xi.float()
        h0 = (cache["ssm"] if cache is not None
              else torch.zeros((B, xi.shape[-1], ds), dtype=torch.float32,
                               device=x.device))

        def step(h, t):
            dt_t, B_t, C_t, x_t = t[:4]
            dA = torch.exp(dt_t[..., None] * A)              # (B, di, ds)
            dBx = (dt_t * x_t)[..., None] * B_t[:, None, :]
            h_new = dA * h + dBx
            if mask is not None:
                # pad steps leave the state untouched, decay included
                h_new = torch.where(t[4][:, None, None], h_new, h)
            return h_new, torch.einsum("bds,bs->bd", h_new, C_t)

        ts = tuple(a.transpose(0, 1) for a in (dt, Bc, Cc, xf))
        if mask is not None:
            ts = ts + (mask.transpose(0, 1),)
        hT, ys = chunked_time_scan(step, h0, ts, chunk=256, remat=S > 256)
        y = ys.transpose(0, 1) + xf * b["D"]                 # (B, S, di)
        y = y.to(x.dtype) * F.silu(z)
        out = m["out_proj"](y)
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(hT)
        return out, cache
