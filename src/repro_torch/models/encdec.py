"""EncDecLM — the encoder-decoder backbone (seamless-m4t-medium).

The speech frontend is a stub: requests carry precomputed frame embeddings
(B, T_enc, d_model), which go straight into the encoder. The backbone is a
bidirectional encoder and a causal decoder with cross attention, every
projection (encoder and decoder self attention, cross attention, FFN)
block-circulant under ``cfg.swm``; the FFN is the GeLU :class:`MLP`.

The reference stacks the encoder's and the decoder's params on a leading
layer axis and runs each stack with ``lax.scan`` (under ``jax.checkpoint``
when ``cfg.remat != "none"``, which changes no value); the port keeps one
module per layer (``encoder.<n>``, ``decoder.<n>``) and runs them in a
Python loop. Under autograd with ``cfg.remat != "none"`` each encoder and
decoder layer is recomputed in the backward (``torch.utils.checkpoint``),
as the reference's per-layer ``jax.checkpoint``: only the residual stream
between layers and the encoder output stay live. The decode cache is
``{"self": [...], "cross": [...]}``, one ``{"k", "v", "pos"}`` dict per
decoder layer in each list, slot axis 0: the decoder's self-attention ring
of ``cache_len`` entries, and the cross attention's K/V of ``enc_seq`` (or
``cache_len``) encoder frames, stashed once at prefill and read back by
every decode step.

On a mesh (``dist.tensor_parallel.shard_model``, which the train step's
and the serve steps' ``mesh=`` run) the modules take this rank's shares
over the ``model`` axis, as the decoder LM's do: the attention heads of
encoder self, decoder self and cross attention, the MLP's blocks and the
tied embedding's vocab rows (``vocab_shard`` = (model axis, first row)
tells the loss which rows of the output table this rank holds). Cross
attention's encoder output enters each layer's sharded region, so that
its gradient partials are summed over the axis. A serving rank's cross
cache shard holds its KV heads or, where ``launch.specs.cache_shardings``
splits the frame axis (``enc_seq`` equal to a channel size the rule
names, as seamless's 4096 = ``d_ff``), its slice of the frames, read
through a combine of the ranks' attention partials
(``nn.attention``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn.attention import Attention, init_kv_cache
from repro_torch.nn.ffn import MLP
from repro_torch.nn.layers import Embedding, RMSNorm

__all__ = ["EncDecLM"]


def _mlp(cfg: ModelConfig) -> MLP:
    return MLP(cfg.d_model, cfg.d_ff, swm=cfg.swm, dtype=cfg.param_dtype)


class _Layer(nn.Module):
    def specs(self):
        return {n: m.specs() for n, m in self._modules.items()}


class EncoderLayer(_Layer):
    """``x += attn(ln1(x))`` (bidirectional); ``x += ffn(ln2(x))``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.add_module("ln1", RMSNorm(cfg.d_model))
        self.add_module("attn", Attention(cfg, causal=False))
        self.add_module("ln2", RMSNorm(cfg.d_model))
        self.add_module("ffn", _mlp(cfg))

    def forward(self, x, positions):
        m = self._modules
        a, _ = m["attn"](m["ln1"](x), positions)
        x = x + a
        return x + m["ffn"](m["ln2"](x))


class DecoderLayer(_Layer):
    """``x += self_attn(ln1(x))`` (causal); ``x += cross_attn(ln_x(x))``
    over the encoder output; ``x += ffn(ln2(x))``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.add_module("ln1", RMSNorm(cfg.d_model))
        self.add_module("self_attn", Attention(cfg, causal=True))
        self.add_module("ln_x", RMSNorm(cfg.d_model))
        self.add_module("cross_attn", Attention(cfg, cross=True))
        self.add_module("ln2", RMSNorm(cfg.d_model))
        self.add_module("ffn", _mlp(cfg))

    def forward(self, x, positions, enc_out, enc_pos, self_cache=None,
                cross_cache=None):
        """Caches, when given, are updated in place. ``enc_out=None`` with
        a cross cache (decode) reads the stashed encoder K/V."""
        m = self._modules
        a, _ = m["self_attn"](m["ln1"](x), positions, cache=self_cache)
        x = x + a
        a, _ = m["cross_attn"](m["ln_x"](x), positions, cache=cross_cache,
                               kv_x=enc_out, kv_positions=enc_pos)
        x = x + a
        return x + m["ffn"](m["ln2"](x))


class EncDecLM(nn.Module):
    """Embedding (tied logits head), encoder and decoder stacks, their
    final norms. Tensors are installed with ``nn.module.load_tree``;
    ``device`` is where caches are allocated (default ``"cuda"``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.add_module("embed", Embedding(cfg.vocab, cfg.d_model,
                                           dtype=cfg.param_dtype))
        self.add_module("enc_norm", RMSNorm(cfg.d_model))
        self.add_module("dec_norm", RMSNorm(cfg.d_model))
        self.add_module("encoder", nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.n_enc_layers
                                             or cfg.n_layers)))
        self.add_module("decoder", nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.n_layers)))
        # set by dist.tensor_parallel.shard_model on a mesh
        self.vocab_shard = None

    def specs(self):
        out = {n: self._modules[n].specs()
               for n in ("embed", "enc_norm", "dec_norm")}
        for n in ("encoder", "decoder"):
            out[n] = {str(i): layer.specs()
                      for i, layer in enumerate(self._modules[n])}
        return out

    def tensor_parallel_refusal(self) -> Optional[str]:
        """What of this model tensor parallelism does not cover, or None:
        FSDP (``cfg.fsdp``), whose per-layer gathers the enc-dec stacks do
        not run."""
        if self.cfg.fsdp:
            return "FSDP of the enc-dec family (cfg.fsdp)"
        return None

    def encode(self, frames: torch.Tensor):
        """frames (B, T, d_model) -> (encoder output (B, T, d), positions
        (B, T) = 0..T-1)."""
        B, T, _ = frames.shape
        pos = torch.arange(T, dtype=torch.int32,
                           device=frames.device).expand(B, T)
        x = frames.to(self.cfg.dtype)
        remat = self._remat()
        for layer in self._modules["encoder"]:
            x = (checkpoint(layer, x, pos, use_reentrant=False) if remat
                 else layer(x, pos))
        return self._modules["enc_norm"](x), pos

    def _remat(self, cache=None) -> bool:
        """Recompute each layer in the backward: a gradient is recorded,
        ``cfg.remat`` asks for it, and no cache is updated in place."""
        return (self.cfg.remat != "none" and cache is None
                and torch.is_grad_enabled())

    def _decode_stack(self, x, positions, enc_out, enc_pos, cache):
        remat = self._remat(cache)
        for i, layer in enumerate(self._modules["decoder"]):
            if remat:
                x = checkpoint(layer, x, positions, enc_out, enc_pos,
                               use_reentrant=False)
            else:
                x = layer(x, positions, enc_out, enc_pos,
                          None if cache is None else cache["self"][i],
                          None if cache is None else cache["cross"][i])
        return self._modules["dec_norm"](x)

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor,
                cache: Optional[dict] = None, logits_mode: str = "all",
                positions: Optional[torch.Tensor] = None):
        """Teacher-forced forward or prefill: frames (B, T, D), tokens
        (B, S) -> (logits, cache). ``positions`` (B, S) default to
        ``0..S-1``; the serve engine passes left-padded buckets whose pad
        lanes carry negative positions, which the causal self attention
        masks (encoder positions are all >= 0, so every real decoder row
        sees the whole encoder output). ``logits_mode`` 'all' | 'last' |
        'none' (the final hidden states instead of logits). The cache, when
        given, is updated in place: the self rings take the prompt, the
        cross caches the encoder's K/V."""
        if logits_mode not in ("all", "last", "none"):
            raise ValueError(f"logits_mode {logits_mode!r}: all | last | none")
        enc_out, enc_pos = self.encode(frames)
        x = self._modules["embed"].encode(tokens)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        x = self._decode_stack(x, positions, enc_out, enc_pos, cache)
        if logits_mode == "none":
            return x, cache
        if logits_mode == "last":
            x = x[:, -1:]
        return self._modules["embed"].decode(x), cache

    def forward_hidden(self, tokens: torch.Tensor, *,
                       frames: Optional[torch.Tensor] = None,
                       img_embeds: Optional[torch.Tensor] = None):
        """Final decoder hidden states (B, S, D) and a zero aux loss, for
        the chunked-loss training path."""
        h, _ = self.forward(frames, tokens, logits_mode="none")
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def output_table(self) -> torch.Tensor:
        """(V, D): the tied embedding."""
        return self._modules["embed"]._buffers["table"]

    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Self rings of ``cache_len`` and cross caches of ``enc_seq`` (or
        ``cache_len``) entries per decoder layer, all unfilled."""
        cfg = self.cfg
        enc_len = cfg.enc_seq or cache_len

        def one(n):
            return init_kv_cache(batch, n, cfg.n_kv_heads, cfg.head_dim,
                                 cfg.dtype, self.device)

        return {"self": [one(cache_len) for _ in range(cfg.n_layers)],
                "cross": [one(enc_len) for _ in range(cfg.n_layers)]}

    def decode_step(self, tokens: torch.Tensor, cache: dict,
                    pos: torch.Tensor):
        """One decoder token per row: tokens (B, 1), pos (B,) -> (logits
        (B, V), cache); cross K/V come from the prefilled cache."""
        x = self._modules["embed"].encode(tokens)
        x = self._decode_stack(x, pos[:, None].to(torch.int32), None, None,
                               cache)
        return self._modules["embed"].decode(x)[:, -1], cache
