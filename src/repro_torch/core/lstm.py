"""SWM-LSTM — the paper's LSTM (§2.2 eq. 1a–1g) with block-circulant
weights.

Google-LSTM: gates from x_t and the projected recurrent output y_{t-1};
diagonal peepholes ``Wic``/``Wfc``/``Woc`` (element-wise, never
circulant); a projection ``Wym`` to d_proj. The eight gate matrices and the
projection are block-circulant with block size k.

Gate fusion (C-LSTM): the four gates read the same ``[x_t ; y_{t-1}]``, so
their eight block tables concatenate (per gate along q, x side then
recurrent side; across gates along p) into one (4·dc/k, (di+dp)/k, k)
table run as ONE stacked-p launch per step through
``core.circulant.block_circulant_apply_multi``, gate biases fused into the
epilogue. Frozen trees carry that table already (``plan.freeze_params``
under ``plan.FUSED_KEY``); frozen trees without it concatenate the
per-side frequency tables (int8 sides dequantized first, since the x and
recurrent halves carry their own scales). When the two sides' block sizes
differ, or SWM is off, each step runs the eight projections one by one.

The reference scans over time with ``lax.scan``; the port runs a Python
loop over T. The cell state stays f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import SWMConfig
from repro_torch.core import circulant as circ
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import ParamSpec

__all__ = ["SWMLSTM"]

_GATES = ("i", "f", "c", "o")


class SWMLSTM(nn.Module):
    """One LSTM layer ``xs (B, T, d_in) -> ys (B, T, d_proj)``. Children
    ``W{g}x``, ``W{g}r`` (g in i/f/c/o) and ``Wym`` are ``Linear``s;
    ``b{g}`` and the peepholes are buffers; a frozen tree may add the
    fused gate group ``_fused``."""

    def __init__(self, d_in: int, d_cell: int, d_proj: int,
                 swm: Optional[SWMConfig] = None, dtype: str = "float32"):
        super().__init__()
        self.d_in, self.d_cell = int(d_in), int(d_cell)
        self.d_proj = int(d_proj)
        self.swm = swm if swm is not None else SWMConfig()
        self.dtype = dtype
        for g in _GATES:
            self.add_module(f"W{g}x", self._lin(d_in, d_cell))
            self.add_module(f"W{g}r", self._lin(d_proj, d_cell))
        self.add_module("Wym", self._lin(d_cell, d_proj))

    def _lin(self, i, o) -> Linear:
        return Linear(i, o, family="lstm", swm=self.swm, dtype=self.dtype)

    def specs(self):
        s = {}
        for g in _GATES:
            s[f"W{g}x"] = self._modules[f"W{g}x"].specs()
            s[f"W{g}r"] = self._modules[f"W{g}r"].specs()
            s[f"b{g}"] = ParamSpec((self.d_cell,), "float32", init="zeros",
                                   axes=(None,))
        for g in ("i", "f", "o"):          # diagonal peepholes
            s[f"W{g}c"] = ParamSpec((self.d_cell,), "float32", init="zeros",
                                    axes=(None,))
        s["Wym"] = self._modules["Wym"].specs()
        return s

    @property
    def _fused_gate_k(self) -> int:
        """Block size of the fused 8-table gate launch; 0 = not fusable."""
        kx = self._modules["Wix"].block_size
        kr = self._modules["Wir"].block_size
        return kx if (kx > 1 and kx == kr) else 0

    def _fused_gate_preacts(self, x_t, y_prev):
        """``[x_t ; y_prev]`` through ONE stacked (4·dc, di+dp) circulant
        launch; the four gate pre-activations, biases fused, peepholes
        not."""
        xy = torch.cat([x_t, y_prev], dim=-1)
        k = self._fused_gate_k
        m, buf = self._modules, self._buffers
        fused = m.get("_fused")
        if fused is not None:
            fb = fused._buffers
            return circ.block_circulant_apply_multi(
                xy, None, impl=self.swm.impl,
                w_freq_cat=(fb["wr"], fb["wi"]),
                w_scale_cat=fb.get("w_scale"),
                splits=(self.d_cell // k,) * 4, bias_cat=fb["bias"], k=k,
                karatsuba=self.swm.karatsuba)
        pairs = [(m[f"W{g}x"], m[f"W{g}r"]) for g in _GATES]
        if all(px.frozen_freq() is not None and pr.frozen_freq() is not None
               for px, pr in pairs):
            # frequency tables only; int8 sides dequantize before the
            # q-axis concat (the x and recurrent halves have their own
            # per-block scales)
            ws, w_freqs = None, []
            for px, pr in pairs:
                xr, xi = circ.dequantize_freq_pair(*px.frozen_freq(),
                                                   px.frozen_scale())
                rr, ri = circ.dequantize_freq_pair(*pr.frozen_freq(),
                                                   pr.frozen_scale())
                w_freqs.append((torch.cat([xr, rr], dim=1),
                                torch.cat([xi, ri], dim=1)))
        else:
            ws = [torch.cat([px._buffers["w"], pr._buffers["w"]], dim=1)
                  for px, pr in pairs]
            w_freqs = None
        return circ.block_circulant_apply_multi(
            xy, ws, biases=[buf[f"b{g}"] for g in _GATES],
            impl=self.swm.impl, w_freqs=w_freqs, k=k,
            karatsuba=self.swm.karatsuba)

    def step(self, x_t, y_prev, c_prev):
        """One LSTM step (eq. 1a–1g). x (B, di), y (B, dp), c (B, dc) ->
        (y, c)."""
        m, buf = self._modules, self._buffers
        sig = torch.sigmoid
        if self._fused_gate_k:
            pre_i, pre_f, pre_c, pre_o = self._fused_gate_preacts(x_t,
                                                                  y_prev)
            i = sig(pre_i + buf["Wic"] * c_prev)
            f = sig(pre_f + buf["Wfc"] * c_prev)
            g = sig(pre_c)
            c = f * c_prev + g * i
            o = sig(pre_o + buf["Woc"] * c)
        else:
            def lin(g):
                return m[f"W{g}x"](x_t) + m[f"W{g}r"](y_prev)

            i = sig(lin("i") + buf["Wic"] * c_prev + buf["bi"])
            f = sig(lin("f") + buf["Wfc"] * c_prev + buf["bf"])
            g = sig(lin("c") + buf["bc"])
            c = f * c_prev + g * i
            o = sig(lin("o") + buf["Woc"] * c + buf["bo"])
        y = m["Wym"](o * torch.tanh(c))
        return y, c

    def forward(self, xs: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """xs (B, T, di) -> (ys (B, T, dp), (yT, cT))."""
        B, T = xs.shape[0], xs.shape[1]
        if state is None:
            y = torch.zeros((B, self.d_proj), dtype=xs.dtype,
                            device=xs.device)
            c = torch.zeros((B, self.d_cell), dtype=torch.float32,
                            device=xs.device)
        else:
            y, c = state
        ys = []
        for t in range(T):
            y, c = self.step(xs[:, t], y, c.float())
            ys.append(y)
        return torch.stack(ys, dim=1), (y, c)
