"""The paper's own evaluation models (§6, Tables 1–2).

* ``SWMMLP``     — MNIST MLPs with block-circulant hidden layers and a
                   dense output layer; ``quant_bits=12`` reproduces the
                   paper's 12-bit fixed-point DCNN rows;
* ``ASICNet``    — Table 2's 512-512-512-64-10 network with 64-point FFT
                   blocks on all but the (dense) output layer;
* ``SWMCNN``     — the LeNet-like CNN of the 99.0% MNIST row, its conv
                   layers block-circulant over channels (CirCNN);
* ``SWMLSTMASR`` — the Google-LSTM ASR model (2 x 1024 cells, 512
                   projection, 39 phones) of Table 1's LSTM rows.

Each is an ``nn.Module`` whose tensors are buffers keyed like the
reference's param tree (``repro/models/paper_models.py``): install a tree
with ``nn.module.load_tree``. Quantization follows the reference exactly:
``SWMMLP`` with ``quant_bits`` applies ``fixed_point`` to every leaf of
each layer's subtree, so on a frozen tree it rounds the frequency tables
(and, for int8 tables, the payload and ``w_scale``), as the reference
does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import SWMConfig
from repro_torch.core.conv import CirculantConv2D
from repro_torch.core.lstm import SWMLSTM
from repro_torch.core.quant import fixed_point
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import ParamSpec

__all__ = ["SWMMLP", "ASICNet", "SWMCNN", "SWMLSTMASR"]


def _linears(dims, swm: SWMConfig):
    """Linears ``dims[i] -> dims[i+1]``; the last is the dense head."""
    return [Linear(dims[i], dims[i + 1],
                   family="head" if i == len(dims) - 2 else "ffn",
                   swm=swm, dtype="float32")
            for i in range(len(dims) - 1)]


class SWMMLP(nn.Module):
    """MLP with block-circulant hidden layers; dense output layer."""

    def __init__(self, dims: Tuple[int, ...] = (784, 512, 512, 10),
                 block_size: int = 64, quant_bits: int = 0,
                 impl: str = "freq"):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        self.block_size, self.quant_bits = int(block_size), int(quant_bits)
        self.impl = impl
        swm = SWMConfig(block_size=self.block_size, impl=impl,
                        targets=("ffn",))
        for i, lin in enumerate(_linears(self.dims, swm)):
            self.add_module(f"fc{i}", lin)

    def _layers(self):
        return [self._modules[f"fc{i}"] for i in range(len(self.dims) - 1)]

    def specs(self):
        s = {}
        for i, lin in enumerate(self._layers()):
            s[f"fc{i}"] = lin.specs()
            s[f"b{i}"] = ParamSpec((self.dims[i + 1],), "float32",
                                   init="zeros", axes=(None,))
        return s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self._layers()
        bits = self.quant_bits
        for i, lin in enumerate(layers):
            w = None
            if bits:
                w = {key: fixed_point(t, bits, bits - 4)
                     for key, t in lin._buffers.items()}
                x = fixed_point(x, bits, bits - 4)
            x = lin(x, params=w) + self._buffers[f"b{i}"]
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x

    @property
    def n_params_dense(self) -> int:
        return sum(self.dims[i] * self.dims[i + 1]
                   for i in range(len(self.dims) - 1))

    @property
    def n_params(self) -> int:
        return sum(lin.n_params for lin in self._layers())


def ASICNet(block_size: int = 64, quant_bits: int = 12) -> SWMMLP:
    """Table 2's exact network: 512-512-512-64-10, 64-point FFT blocks."""
    return SWMMLP(dims=(512, 512, 512, 64, 10), block_size=block_size,
                  quant_bits=quant_bits)


class SWMCNN(nn.Module):
    """LeNet-like CNN with block-circulant conv and FC layers (the 99.0%
    MNIST row). ``quant_bits`` is kept as a field, as in the reference,
    whose forward does not read it."""

    def __init__(self, in_hw: int = 28,
                 channels: Tuple[int, ...] = (1, 32, 64),
                 fc_dims: Tuple[int, ...] = (1024, 128, 10),
                 conv_block: int = 8, fc_block: int = 64,
                 quant_bits: int = 0):
        super().__init__()
        self.in_hw = int(in_hw)
        self.channels, self.fc_dims = tuple(channels), tuple(fc_dims)
        self.conv_block, self.fc_block = int(conv_block), int(fc_block)
        self.quant_bits = int(quant_bits)
        for i in range(len(self.channels) - 1):
            self.add_module(f"conv{i}", CirculantConv2D(
                self.channels[i], self.channels[i + 1], ksize=5,
                block_size=self.conv_block))
        swm = SWMConfig(block_size=self.fc_block, targets=("ffn",))
        for i, lin in enumerate(_linears(self.fc_dims, swm)):
            self.add_module(f"fc{i}", lin)

    def _convs(self):
        return [self._modules[f"conv{i}"]
                for i in range(len(self.channels) - 1)]

    def _fcs(self):
        return [self._modules[f"fc{i}"]
                for i in range(len(self.fc_dims) - 1)]

    def specs(self):
        s = {}
        for i, c in enumerate(self._convs()):
            s[f"conv{i}"] = c.specs()
        for i, lin in enumerate(self._fcs()):
            s[f"fc{i}"] = lin.specs()
            s[f"fb{i}"] = ParamSpec((self.fc_dims[i + 1],), "float32",
                                    init="zeros", axes=(None,))
        return s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 1) -> logits (B, 10)."""
        for conv in self._convs():
            x = torch.relu(conv(x))
            # 2x2 max-pool
            B, H, W, C = x.shape
            x = x[:, : H // 2 * 2, : W // 2 * 2, :]
            x = x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))
        x = x.reshape(x.shape[0], -1)
        if x.shape[-1] != self.fc_dims[0]:
            raise ValueError(f"flattened features {tuple(x.shape)} do not "
                             f"match fc_dims[0] = {self.fc_dims[0]}")
        fcs = self._fcs()
        for i, lin in enumerate(fcs):
            x = lin(x) + self._buffers[f"fb{i}"]
            if i < len(fcs) - 1:
                x = torch.relu(x)
        return x


class SWMLSTMASR(nn.Module):
    """Stacked Google-LSTM for TIMIT-like ASR (Table 1 LSTM rows): 153
    input features, 2 layers x 1024 cells, 512 projection, 39 phones."""

    def __init__(self, d_in: int = 153, d_cell: int = 1024,
                 d_proj: int = 512, n_layers: int = 2, n_phones: int = 39,
                 block_size: int = 16):
        super().__init__()
        self.d_in, self.d_cell = int(d_in), int(d_cell)
        self.d_proj = int(d_proj)
        self.n_layers, self.n_phones = int(n_layers), int(n_phones)
        self.block_size = int(block_size)
        swm = SWMConfig(block_size=self.block_size, targets=("lstm",))
        for i in range(self.n_layers):
            self.add_module(f"lstm{i}", SWMLSTM(
                self.d_in_padded if i == 0 else self.d_proj, self.d_cell,
                self.d_proj, swm=swm))
        self.add_module("out", Linear(self.d_proj, self.n_phones,
                                      family="head", swm=swm,
                                      dtype="float32"))

    @property
    def d_in_padded(self) -> int:
        """The 153 features zero-padded to a block multiple, so the input
        gate matrices are circulant too."""
        k = max(1, self.block_size)
        return -(-self.d_in // k) * k

    def specs(self):
        s = {f"lstm{i}": self._modules[f"lstm{i}"].specs()
             for i in range(self.n_layers)}
        s["out"] = self._modules["out"].specs()
        s["out_b"] = ParamSpec((self.n_phones,), "float32", init="zeros",
                               axes=(None,))
        return s

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """xs (B, T, d_in) -> per-frame phone logits (B, T, n_phones)."""
        pad = self.d_in_padded - self.d_in
        h = torch.nn.functional.pad(xs, (0, pad)) if pad else xs
        for i in range(self.n_layers):
            h, _ = self._modules[f"lstm{i}"](h)
        return self._modules["out"](h) + self._buffers["out_b"]
