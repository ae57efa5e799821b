"""HybridDecoderLM — the decoder-only backbone (attention mixers, dense FFN).

The reference stacks each layer group's params on a leading ``repeat``
axis and runs the group with ``lax.scan``; the port keeps one
:class:`DecoderLayer` module per layer (``layers.<i>``, in execution order)
and runs them in a Python loop. Caches are a list with one
``{"k", "v", "pos"}`` dict per layer, slot axis 0. Under autograd with
``cfg.remat != "none"`` each layer is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's per-layer
``jax.checkpoint``: only the residual stream between layers stays live.
Other mixers (mamba, rwkv, local attention), MoE FFNs and untied logits
heads raise until their slices are ported.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn.attention import Attention, init_kv_cache
from repro_torch.nn.ffn import SwiGLU
from repro_torch.nn.layers import Embedding, RMSNorm

__all__ = ["HybridDecoderLM", "DecoderLayer"]


class DecoderLayer(nn.Module):
    """Pre-norm block: ``x += mixer(ln1(x)); x += ffn(ln2(x))``."""

    def __init__(self, cfg: ModelConfig, lspec: LayerSpec):
        super().__init__()
        if lspec.mixer != "attn":
            raise NotImplementedError(
                f"mixer {lspec.mixer!r} is not ported yet (attn only)")
        if lspec.ffn != "dense":
            raise NotImplementedError(
                f"ffn {lspec.ffn!r} is not ported yet (dense only)")
        self.add_module("ln1", RMSNorm(cfg.d_model))
        self.add_module("mixer", Attention(cfg))
        self.add_module("ln2", RMSNorm(cfg.d_model))
        self.add_module("ffn_dense", SwiGLU(cfg.d_model, cfg.d_ff,
                                            swm=cfg.swm,
                                            dtype=cfg.param_dtype))

    def specs(self):
        return {n: self._modules[n].specs()
                for n in ("ln1", "mixer", "ln2", "ffn_dense")}

    def forward(self, x, positions, cache=None):
        m = self._modules
        mo, cache = m["mixer"](m["ln1"](x), positions, cache=cache)
        x = x + mo
        x = x + m["ffn_dense"](m["ln2"](x))
        return x, cache


def _layer_out(layer: DecoderLayer, x, positions):
    return layer(x, positions)[0]


class HybridDecoderLM(nn.Module):
    """Embedding, per-layer blocks, final norm, tied logits head.
    Tensors are installed with ``nn.module.load_tree``; ``device`` is where
    caches are allocated (default ``"cuda"``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if not cfg.tie_embeddings:
            raise NotImplementedError("untied logits heads are not ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.add_module("embed", Embedding(cfg.vocab, cfg.d_model,
                                           dtype=cfg.param_dtype))
        self.add_module("final_norm", RMSNorm(cfg.d_model))
        self.add_module("layers", nn.ModuleList(
            DecoderLayer(cfg, lspec) for lspec in cfg.layer_specs()))

    def specs(self):
        return {
            "embed": self._modules["embed"].specs(),
            "final_norm": self._modules["final_norm"].specs(),
            "layers": {str(i): layer.specs()
                       for i, layer in enumerate(self._modules["layers"])},
        }

    def init_cache(self, batch: int, cache_len: int) -> List[dict]:
        cfg = self.cfg
        return [init_kv_cache(batch, cache_len, cfg.n_kv_heads, cfg.head_dim,
                              cfg.dtype, self.device)
                for _ in self._modules["layers"]]

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[List[dict]] = None,
                logits_mode: str = "all"):
        """tokens (B, S) -> (logits, cache). ``positions`` (B, S) default
        to ``0..S-1``; negative positions (left-pad lanes) are masked out
        of attention. ``logits_mode`` 'all' | 'last' (only the final
        position goes through the head) | 'none' (the final hidden states
        instead of logits, for the chunked training loss). The cache, when
        given, is updated in place."""
        if logits_mode not in ("all", "last", "none"):
            raise ValueError(f"logits_mode {logits_mode!r}: all | last | none")
        x = self._modules["embed"].encode(tokens)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        remat = (self.cfg.remat != "none" and cache is None
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self._modules["layers"]):
            if remat:
                x = checkpoint(_layer_out, layer, x, positions,
                               use_reentrant=False)
            else:
                x, _ = layer(x, positions,
                             None if cache is None else cache[i])
        x = self._modules["final_norm"](x)
        if logits_mode == "none":
            return x, cache
        if logits_mode == "last":
            x = x[:, -1:]
        return self._modules["embed"].decode(x), cache

    def forward_hidden(self, tokens: torch.Tensor):
        """Final hidden states for chunked-loss training: (hidden (B, S,
        D), aux), aux being the MoE auxiliary loss (0: no MoE layers)."""
        h, _ = self.forward(tokens, logits_mode="none")
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def output_table(self) -> torch.Tensor:
        """(V, D) matrix the chunked loss uses: the tied embedding."""
        return self._modules["embed"]._buffers["table"]

    def decode_step(self, tokens, cache, pos):
        """One-token decode: tokens (B, 1), pos (B,) -> (logits (B, V),
        cache)."""
        logits, cache = self.forward(tokens, positions=pos[:, None].to(
            torch.int32), cache=cache)
        return logits[:, -1], cache
