"""HybridDecoderLM — the decoder-only backbone for the LM-family archs.

Covers dense transformers (qwen3, deepseek, internlm2), the 5 local : 1
global sliding-window interleave (gemma3), MoE (qwen3-moe; arctic with its
parallel dense residual), prefix-LM decoding behind an image prefix
(paligemma), Mamba + attention hybrids with MoE every other layer (jamba)
and attention-free RWKV-6 (rwkv6): the mixers ``attn``, ``attn_local``,
``mamba`` and ``rwkv``, the FFNs ``dense``, ``moe`` and ``dense+moe`` (rwkv
layers take the RWKV channel mix), tied or untied logits heads.

The reference stacks each layer group's params on a leading ``repeat``
axis and runs the group with ``lax.scan``; the port keeps one
:class:`DecoderLayer` module per layer (``layers.<i>``, in execution order)
and runs them in a Python loop. Caches are a list with one dict per layer,
slot axis 0: ``{"k", "v", "pos"}`` for attention, ``{"conv", "ssm"}`` for
Mamba, ``{"shift_att", "shift_ffn", "wkv"}`` for RWKV. Under autograd with
``cfg.remat != "none"`` each layer is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's per-layer
``jax.checkpoint``: only the residual stream between layers stays live.
An ``attn_local`` layer's KV cache is a ring of
:func:`local_attn_cache_len` entries; every attention layer takes the
prefix-LM span ``cfg.n_img_tokens``, and ``img_embeds`` (B, P, D) go in
front of the token embeddings.

On a mesh (``dist.tensor_parallel.shard_model``, which the train step's
``mesh=`` runs) the modules take this rank's shares: attention heads,
Mamba channels, RWKV heads, FFN and expert blocks and vocab rows over
the ``model`` axis, and, for an FSDP config, ``embed``-sharded leaves over
the data axes. Then ``fsdp`` (a ``FSDPPlan``) gathers each layer's leaves
at use, inside the layer's remat recompute too, and the embedding's and
the output table's before theirs; ``vocab_shard`` = (model axis, first
row) tells the loss which rows of the output table this rank holds.
Tensor parallelism covers the ``lm`` family's attention, Mamba and RWKV
mixers (a Mamba layer's channels, an RWKV layer's heads and channel-mix
blocks over ``model``): :meth:`tensor_parallel_refusal` names paligemma's
vision prefix.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn.attention import Attention, init_kv_cache
from repro_torch.nn.ffn import SwiGLU
from repro_torch.nn.layers import Embedding, RMSNorm
from repro_torch.nn.linear import Linear
from repro_torch.nn.moe import MoE
from repro_torch.nn.rwkv import (RWKV6ChannelMix, RWKV6TimeMix,
                                 init_rwkv_cache)
from repro_torch.nn.ssm import Mamba, init_mamba_cache

__all__ = ["HybridDecoderLM", "DecoderLayer", "local_attn_cache_len"]

RECURRENT_MIXERS = ("mamba", "rwkv")
ATTENTION_MIXERS = ("attn", "attn_local")


def local_attn_cache_len(cfg: ModelConfig, cache_len: int) -> int:
    """Ring length an ``attn_local`` layer's KV cache is allocated with:
    the sliding window, or ``cache_len`` when that is shorter."""
    return min(cfg.sliding_window or cache_len, cache_len)


def _mixer(cfg: ModelConfig, kind: str) -> nn.Module:
    if kind in ATTENTION_MIXERS:
        return Attention(cfg, local=kind == "attn_local",
                         prefix_len=cfg.n_img_tokens)
    if kind == "mamba":
        return Mamba(cfg)
    if kind == "rwkv":
        return RWKV6TimeMix(cfg)
    raise ValueError(f"unknown mixer {kind!r}")


class DecoderLayer(nn.Module):
    """Pre-norm block: ``x += mixer(ln1(x)); x += ffn(ln2(x))``, the FFN
    being the dense FFN, the MoE or their sum (``dense+moe``)."""

    def __init__(self, cfg: ModelConfig, lspec: LayerSpec):
        super().__init__()
        self.mixer_kind = lspec.mixer
        self.add_module("ln1", RMSNorm(cfg.d_model))
        self.add_module("mixer", _mixer(cfg, lspec.mixer))
        self.add_module("ln2", RMSNorm(cfg.d_model))
        if lspec.mixer == "rwkv":
            self.add_module("ffn_dense", RWKV6ChannelMix(cfg))
            return
        if lspec.ffn not in ("dense", "moe", "dense+moe"):
            raise ValueError(f"unknown ffn {lspec.ffn!r}")
        if lspec.ffn in ("dense", "dense+moe"):
            self.add_module("ffn_dense", SwiGLU(cfg.d_model, cfg.d_ff,
                                                swm=cfg.swm,
                                                dtype=cfg.param_dtype))
        if lspec.ffn in ("moe", "dense+moe"):
            self.add_module("ffn_moe", MoE(
                cfg.d_model, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts,
                cfg.n_experts_per_token, cfg.capacity_factor, swm=cfg.swm,
                dtype=cfg.param_dtype))

    def specs(self):
        return {n: mod.specs() for n, mod in self._modules.items()}

    def init_cache(self, cfg: ModelConfig, batch: int, cache_len: int,
                   device) -> dict:
        kind = self.mixer_kind
        if kind in ATTENTION_MIXERS:
            if kind == "attn_local":
                cache_len = local_attn_cache_len(cfg, cache_len)
            return init_kv_cache(batch, cache_len, cfg.n_kv_heads,
                                 cfg.head_dim, cfg.dtype, device)
        if kind == "mamba":
            m = self._modules["mixer"]
            return init_mamba_cache(batch, m.d_inner, cfg.mamba_d_state,
                                    cfg.mamba_d_conv, cfg.dtype, device)
        return init_rwkv_cache(batch, cfg.d_model,
                               cfg.d_model // cfg.rwkv_head_dim,
                               cfg.rwkv_head_dim, cfg.dtype, device)

    def forward(self, x, positions, cache=None, mask=None,
                moe_no_drop: bool = False):
        """(x, cache, aux): the cache, when given, is updated in place;
        ``aux`` is the MoE load-balance loss (0 without MoE). ``mask``
        (the validity of each position) goes to the recurrent mixers and
        the RWKV channel mix only: attention masks pads through negative
        positions."""
        m = self._modules
        h = m["ln1"](x)
        if self.mixer_kind in ATTENTION_MIXERS:
            mo, _ = m["mixer"](h, positions, cache=cache)
        else:
            mo, _ = m["mixer"](h, cache=cache, mask=mask)
        x = x + mo
        h = m["ln2"](x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        out = None
        if "ffn_dense" in m:
            if self.mixer_kind == "rwkv":
                out, _ = m["ffn_dense"](h, cache=cache, mask=mask)
            else:
                out = m["ffn_dense"](h)
        if "ffn_moe" in m:
            fo, a = m["ffn_moe"](h, no_drop=moe_no_drop)
            out = fo if out is None else out + fo
            aux = aux + a
        return x + out, cache, aux


def _gathered(fsdp, unit: str):
    """``fsdp``'s gather of ``unit`` (a no-op without FSDP)."""
    return (contextlib.nullcontext() if fsdp is None
            else fsdp.gathered(unit))


def _layer_out(layer: DecoderLayer, x, positions, fsdp=None, unit=""):
    with _gathered(fsdp, unit):
        x, _, aux = layer(x, positions)
    return x, aux


class HybridDecoderLM(nn.Module):
    """Embedding, per-layer blocks, final norm, tied or untied logits head.
    Tensors are installed with ``nn.module.load_tree``; ``device`` is where
    caches are allocated (default ``"cuda"``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.add_module("embed", Embedding(cfg.vocab, cfg.d_model,
                                           dtype=cfg.param_dtype))
        self.add_module("final_norm", RMSNorm(cfg.d_model))
        if not cfg.tie_embeddings:
            # family "head" is not a circulant target: a dense (d, V) table
            self.add_module("lm_head", Linear(cfg.d_model, cfg.vocab,
                                              family="head", swm=cfg.swm,
                                              dtype=cfg.param_dtype,
                                              in_axis="embed",
                                              out_axis="vocab"))
        self.add_module("layers", nn.ModuleList(
            DecoderLayer(cfg, lspec) for lspec in cfg.layer_specs()))
        # set by dist.tensor_parallel.shard_model on a mesh
        self.vocab_shard, self.fsdp = None, None

    def specs(self):
        out = {n: self._modules[n].specs()
               for n in ("embed", "final_norm", "lm_head")
               if n in self._modules}
        out["layers"] = {str(i): layer.specs()
                         for i, layer in enumerate(self._modules["layers"])}
        return out

    def tensor_parallel_refusal(self) -> Optional[str]:
        """What of this model tensor parallelism does not cover, or None:
        paligemma's vision prefix."""
        if self.cfg.family == "vlm" or self.cfg.n_img_tokens:
            return "paligemma's vision prefix (family 'vlm')"
        return None

    def has_recurrent(self) -> bool:
        """True when any layer carries recurrent (mamba/rwkv) state."""
        return any(layer.mixer_kind in RECURRENT_MIXERS
                   for layer in self._modules["layers"])

    def init_cache(self, batch: int, cache_len: int) -> List[dict]:
        return [layer.init_cache(self.cfg, batch, cache_len, self.device)
                for layer in self._modules["layers"]]

    def _trunk(self, tokens, positions, cache, moe_no_drop, img_embeds=None):
        """Embedding (after the image prefix, when given), every layer and
        the final norm: (hidden, aux)."""
        with _gathered(self.fsdp, "embed"):
            x = self._modules["embed"].encode(tokens)
        if img_embeds is not None:
            x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        # the serve engine's left-pad lanes carry negative positions; the
        # recurrent mixers take their validity as a mask
        mask = (positions >= 0 if positions is not None
                and self.has_recurrent() else None)
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        remat = (self.cfg.remat != "none" and cache is None
                 and torch.is_grad_enabled())
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self._modules["layers"]):
            if remat:
                x, a = checkpoint(_layer_out, layer, x, positions, self.fsdp,
                                  f"layers.{i}", use_reentrant=False)
            else:
                with _gathered(self.fsdp, f"layers.{i}"):
                    x, _, a = layer(x, positions,
                                    None if cache is None else cache[i],
                                    mask, moe_no_drop)
            aux = aux + a
        return self._modules["final_norm"](x), aux

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                img_embeds: Optional[torch.Tensor] = None,
                cache: Optional[List[dict]] = None,
                logits_mode: str = "all", moe_no_drop: bool = False):
        """tokens (B, S) -> (logits, cache). ``img_embeds`` (B, P, D), the
        VLM's image prefix, go in front of the token embeddings (logits
        then cover P + S positions). ``positions`` (B, S) default
        to ``0..S-1``; negative positions (left-pad lanes) are masked out
        of attention, and when given on a model with recurrent mixers their
        validity ``positions >= 0`` keeps pad lanes out of every recurrent
        state. ``logits_mode`` 'all' | 'last' (only the final position
        goes through the head) | 'none' (the final hidden states instead
        of logits, for the chunked training loss). ``moe_no_drop=True`` is
        the serving MoE dispatch. The cache, when given, is updated in
        place."""
        if logits_mode not in ("all", "last", "none"):
            raise ValueError(f"logits_mode {logits_mode!r}: all | last | none")
        x, _ = self._trunk(tokens, positions, cache, moe_no_drop, img_embeds)
        if logits_mode == "none":
            return x, cache
        if logits_mode == "last":
            x = x[:, -1:]
        return self._logits(x), cache

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits: the tied embedding, or the untied head in f32."""
        if self.cfg.tie_embeddings:
            with _gathered(self.fsdp, "embed"):
                return self._modules["embed"].decode(x)
        with _gathered(self.fsdp, "lm_head"):
            w = self._modules["lm_head"]._buffers["w"]
        if self.vocab_shard is None:
            return x.float() @ w.float()
        from repro_torch.dist.sharding import gather_replicated, region_input

        axis = self.vocab_shard[0]
        return gather_replicated(region_input(x, axis).float() @ w.float(),
                                 axis, -1)

    def forward_hidden(self, tokens: torch.Tensor, *,
                       img_embeds: Optional[torch.Tensor] = None):
        """Final hidden states for chunked-loss training: (hidden (B, P +
        S, D), aux), aux being the summed MoE auxiliary loss (0 without
        MoE)."""
        return self._trunk(tokens, None, None, False, img_embeds)

    def output_table(self) -> torch.Tensor:
        """(V, D) matrix the chunked loss uses: the tied embedding or the
        untied head's transpose (this rank's ``vocab_shard`` rows on a
        ``model`` axis; whole over the data axes, gathered for FSDP)."""
        if self.cfg.tie_embeddings:
            with _gathered(self.fsdp, "embed"):
                return self._modules["embed"]._buffers["table"]
        with _gathered(self.fsdp, "lm_head"):
            return self._modules["lm_head"]._buffers["w"].T

    def decode_step(self, tokens, cache, pos, moe_no_drop: bool = False):
        """One-token decode: tokens (B, 1), pos (B,) -> (logits (B, V),
        cache)."""
        logits, cache = self.forward(tokens, positions=pos[:, None].to(
            torch.int32), cache=cache, moe_no_drop=moe_no_drop)
        return logits[:, -1], cache

    def prefill(self, tokens, cache, img_embeds=None):
        """Prompt forward into ``cache`` (positions ``0..P+S-1``): (the last
        position's logits (B, V), cache)."""
        logits, cache = self.forward(tokens, cache=cache,
                                     img_embeds=img_embeds,
                                     logits_mode="last")
        return logits[:, -1], cache
