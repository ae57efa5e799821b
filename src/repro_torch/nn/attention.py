"""Grouped-query attention: rotary, qk-norm, sliding window, prefix-LM,
bidirectional (encoder) and cross attention, ring-buffer KV cache.

GQA/MQA with optional qk-norm (qwen3). Masks are predicates over absolute
positions: keys with negative ``kv_pos`` (unfilled cache slots and the
serve engine's left-pad lanes) are always masked; causal keys sit at or
before the query, or inside the prefix-LM span ``kv_pos < prefix_len``
(paligemma's image prefix, attended bidirectionally); local layers
(gemma3's sliding window) also need ``q_pos - kv_pos < window``;
``causal=False`` (the enc-dec encoder, and cross attention) drops the
causal predicate. A local layer's KV cache is a ring of the window's
length, written at ``pos % ring``; the positions stored beside k/v mask
its stale slots exactly. Local layers rotate with
``cfg.rope_theta_local``, global ones with ``cfg.rope_theta``. Cross
attention (enc-dec) takes q from x and k/v from the encoder output
``kv_x``, without rope; at prefill its cache stashes the encoder's K/V and
positions, and decode steps read them back. Long queries (``S >
flash_q_chunk``) use a chunked online-softmax attention written as plain
PyTorch loops over every KV chunk (the reference's window span slicing
only skips fully masked chunks, which the loops compute and mask). The KV
cache is updated in place.

Under tensor parallelism (``tp``, a ``dist.tensor_parallel.AttnLayout``
set by ``shard_model``; self-attention, in training and serving) the
layer computes the query heads its q blocks touch: x enters the region
once, q/k/v come from this rank's column blocks (one fused launch whose
splits are local, time-domain or frozen tables), its K/V are its own
blocks, the all-gathered blocks cut to the KV heads its query heads read,
or (whole tables, entering the region so that their gradient partials are
summed) the whole K/V cut the same way; qk-norm scales enter the region
too. ``o`` holds the input blocks of exactly the query features this rank
produced and sums the partial outputs. A serving rank's cache shard holds
the KV heads ``launch.specs.cache_shardings`` gives it (its share when
the ``model`` axis divides the KV heads, else all of them), whatever its
tables' layout: it writes exactly those, all-gathering K/V first when it
holds them all and its tables a part. Cross attention stays unsharded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import circulant as circ
from repro_torch.dist.sharding import gather_along, region_input
from repro_torch.kernels.block_circulant.plan import FUSED_KEY
from repro_torch.nn.layers import RMSNorm, apply_rope, rotary
from repro_torch.nn.linear import Linear

__all__ = ["Attention", "init_kv_cache", "flash_attention"]

_NEG = -2.0e38


def init_kv_cache(batch, cache_len, n_kv, head_dim, dtype, device):
    """Empty cache; pos = -1 marks an unfilled (always-masked) slot."""
    return {
        "k": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               prefix_len: int = 0) -> torch.Tensor:
    """(B, Sq, Skv) additive f32 bias from position predicates: valid cache
    slots (``kv_pos >= 0``); when ``causal``, keys at or before the query
    or (``prefix_len > 0``) inside the bidirectional prefix; when
    ``window > 0``, keys less than ``window`` positions back."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    ok = kp >= 0
    if causal:
        c = kp <= qp
        if prefix_len > 0:
            c = c | (kp < prefix_len)
        ok = ok & c
    if window > 0:
        ok = ok & (qp - kp < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), _NEG, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)


def _scores(q, k, softcap):
    """(B, Sq, HKV, G, hd) x (B, Skv, HKV, hd) -> f32 (B, HKV, G, Sq, Skv)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    s = s * (q.shape[-1] ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    return s


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: int = 0, prefix_len: int = 0,
                    softcap: float = 0.0, q_chunk: int = 512,
                    kv_chunk: int = 1024):
    """Online-softmax attention over KV chunks, O(S·chunk) memory.
    q (B, Sq, HKV, G, hd), k/v (B, Skv, HKV, hd) -> (B, Sq, HKV, G, hd)."""
    B, Sq, HKV, G, hd = q.shape
    Skv = k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qi, qpi = q[:, q0:q0 + q_chunk], q_pos[:, q0:q0 + q_chunk]
        qc = qi.shape[1]
        m = torch.full((B, HKV, G, qc), float("-inf"), device=q.device)
        l = torch.zeros((B, HKV, G, qc), device=q.device)
        acc = torch.zeros((B, HKV, G, qc, hd), device=q.device)
        for k0 in range(0, Skv, kv_chunk):
            ki, vi = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            s = _scores(qi, ki, softcap) + _mask_bias(
                qpi, kv_pos[:, k0:k0 + kv_chunk], causal=causal,
                window=window, prefix_len=prefix_len)[:, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(qi.dtype).float(), vi.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, qc, HKV, G, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def _direct_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                      window: int = 0, prefix_len: int = 0,
                      softcap: float = 0.0):
    """Small-Sq path (decode, short prefill): one materialized score
    tensor."""
    s = _scores(q, k, softcap) + _mask_bias(
        q_pos, kv_pos, causal=causal, window=window,
        prefix_len=prefix_len)[:, None, None]
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(q.dtype), v)


class Attention(nn.Module):
    """Self-attention with a fused QKV launch when all three projections
    are circulant with one block size, or cross attention. ``local`` makes
    it a sliding-window layer (``cfg.sliding_window``,
    ``cfg.rope_theta_local``); ``prefix_len`` is the bidirectional
    prefix-LM span; ``causal=False`` attends both ways (the encoder);
    ``cross`` takes k/v from ``kv_x`` or the cache, never fused (a frozen
    tree's ``FUSED_KEY`` table, which freezing attaches to any q/k/v
    triple, goes unread), without rope and unmasked by causality."""

    def __init__(self, cfg: ModelConfig, local: bool = False,
                 prefix_len: int = 0, cross: bool = False,
                 causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.prefix_len = int(prefix_len)
        self.cross = bool(cross)
        self.causal = bool(causal)
        self.window = cfg.sliding_window if local else 0
        self.rope_theta = cfg.rope_theta_local if local else cfg.rope_theta
        hd = cfg.head_dim

        def proj(i, o, ia, oa):
            return Linear(i, o, family="attn", swm=cfg.swm,
                          dtype=cfg.param_dtype, in_axis=ia, out_axis=oa)

        self.add_module("q", proj(cfg.d_model, cfg.n_heads * hd, "embed",
                                  "heads"))
        self.add_module("k", proj(cfg.d_model, cfg.n_kv_heads * hd, "embed",
                                  "kv_heads"))
        self.add_module("v", proj(cfg.d_model, cfg.n_kv_heads * hd, "embed",
                                  "kv_heads"))
        self.add_module("o", proj(cfg.n_heads * hd, cfg.d_model, "heads",
                                  "embed"))
        if cfg.qk_norm:
            self.add_module("q_norm", RMSNorm(hd))
            self.add_module("k_norm", RMSNorm(hd))
        self.tp = None

    def specs(self):
        return {n: m.specs() for n, m in self._modules.items()
                if n != FUSED_KEY}

    def _fused_qkv(self, x):
        """Q/K/V as ONE stacked-p circulant launch, or None when the three
        tables are not circulant with one block size. Frozen trees carry
        the pre-concatenated table under ``FUSED_KEY``."""
        projs = [self._modules[n] for n in ("q", "k", "v")]
        kb = projs[0].block_size
        if not all(p.is_circulant and p.block_size == kb for p in projs):
            return None
        impl = self.cfg.swm.impl
        fused = self._modules.get(FUSED_KEY)
        if fused is not None:
            fb = fused._buffers
            # the members' p blocks: this rank's under tensor parallelism
            return circ.block_circulant_apply_multi(
                x, None, impl=impl, w_freq_cat=(fb["wr"], fb["wi"]),
                w_scale_cat=fb.get("w_scale"),
                splits=tuple(p._buffers["wr"].shape[-3] for p in projs),
                k=kb, karatsuba=self.cfg.swm.karatsuba)
        frozen = all(p.frozen_freq() is not None for p in projs)
        return circ.block_circulant_apply_multi(
            x, None if frozen else [p._buffers["w"] for p in projs],
            impl=impl,
            # int8 per-projection tables dequantize here (the multi path
            # concatenates plain f32 tables)
            w_freqs=([circ.dequantize_freq_pair(*p.frozen_freq(),
                                                p.frozen_scale())
                      for p in projs] if frozen else None),
            k=kb, karatsuba=self.cfg.swm.karatsuba)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[dict] = None,
                kv_x: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """x (B, S, D), positions (B, S) -> (out, cache). ``kv_x`` (B, T, D)
        is the cross-attention source (the encoder output) and
        ``kv_positions`` (B, T) its positions (self-attention: the keys'
        positions, default ``positions``). The cache, when given, is
        updated in place and returned: a self-attention cache by a ring
        write; a cross cache, when ``kv_x`` is given (prefill), by the
        fresh K/V and ``kv_positions`` replacing its entries (the
        reference's ``update_cache``, which its callers set exactly when
        they pass ``kv_x``); in decode, ``kv_x=None``, it is only read."""
        if self.tp is not None:
            if kv_x is not None or self.cross:
                raise NotImplementedError(
                    "tensor-parallel attention runs self-attention only: "
                    "cross attention (the enc-dec family) under a 'model' "
                    "mesh axis is not ported (ROADMAP.md Queue 1)")
            return self._forward_tp(x, positions, kv_positions, cache)
        cfg = self.cfg
        B, S, _ = x.shape
        hd, HQ, HKV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        m = self._modules
        qkv = (self._fused_qkv(x) if kv_x is None and not self.cross
               else None)
        if qkv is not None:
            q = qkv[0].reshape(B, S, HQ, hd)
            k = qkv[1].reshape(B, S, HKV, hd)
            v = qkv[2].reshape(B, S, HKV, hd)
        else:
            q = m["q"](x).reshape(B, S, HQ, hd)
            if self.cross and cache is not None and kv_x is None:
                k = v = None                 # cross decode: K/V from cache
            else:
                src = x if kv_x is None else kv_x
                k = m["k"](src).reshape(B, src.shape[1], HKV, hd)
                v = m["v"](src).reshape(B, src.shape[1], HKV, hd)
        if cfg.qk_norm:
            q = m["q_norm"](q)
            if k is not None:
                k = m["k_norm"](k)
        if not self.cross:
            rope = rotary(positions, hd, self.rope_theta)
            q = apply_rope(q, *rope)
            if k is not None:
                if kv_positions is not None:
                    rope = rotary(kv_positions, hd, self.rope_theta)
                k = apply_rope(k, *rope)

        if cache is not None and self.cross:
            if k is not None:                     # prefill: stash enc K/V
                cache["k"] = k.to(cache["k"].dtype)
                cache["v"] = v.to(cache["v"].dtype)
                cache["pos"] = kv_positions.to(torch.int32)
            # prefill and decode alike attend over the cache's contents
            k_att, v_att = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
            kv_pos = cache["pos"]
        elif cache is not None:
            cache = self._write_cache(cache, k, v, positions)
            # the layer's own cache length: a local layer's is its ring
            if S == 1 or S < cache["k"].shape[1]:
                # decode / short append: attend over the cache
                k_att, v_att = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
                kv_pos = cache["pos"]
            else:
                # prefill covering the whole cache: attend over fresh kv
                k_att, v_att, kv_pos = k, v, positions
        else:
            k_att, v_att = k, v
            kv_pos = positions if kv_positions is None else kv_positions

        qg = q.reshape(B, S, HKV, HQ // HKV, hd)
        out = self._attend(qg, k_att, v_att, positions, kv_pos,
                           self.causal and not self.cross)
        return m["o"](out.reshape(B, S, HQ * hd)), cache

    def _attend(self, qg, k, v, positions, kv_pos, causal: bool):
        """The chunked flash attention past ``flash_q_chunk`` queries, the
        direct one below it."""
        cfg = self.cfg
        masks = dict(causal=causal, window=self.window,
                     prefix_len=self.prefix_len, softcap=cfg.logit_softcap)
        if qg.shape[1] > cfg.flash_q_chunk:
            return flash_attention(qg, k, v, positions, kv_pos,
                                   q_chunk=cfg.flash_q_chunk,
                                   kv_chunk=cfg.flash_kv_chunk, **masks)
        return _direct_attention(qg, k, v, positions, kv_pos, **masks)

    def _qkv_tp(self, x):
        """q, k, v from this rank's tables: frozen ones through the fused
        launch (or one launch each), time-domain ones through one launch
        of the three tables, whole K/V tables entering the region so that
        their gradient partials are summed."""
        cfg, lay, m = self.cfg, self.tp, self._modules
        projs = [m[n] for n in ("q", "k", "v")]
        frozen = [p.frozen_freq() is not None for p in projs]
        if any(frozen):
            qkv = self._fused_qkv(x) if all(frozen) else None
            return qkv if qkv is not None else [p(x) for p in projs]
        w = {n: m[n]._buffers["w"] for n in ("q", "k", "v")}
        if lay.kv == "replicated":
            w["k"], w["v"] = (region_input(w[n], lay.axis) for n in ("k", "v"))
        kb = projs[0].block_size
        if all(p.is_circulant and p.block_size == kb for p in projs):
            return circ.block_circulant_apply_multi(
                x, [w["q"], w["k"], w["v"]], impl=cfg.swm.impl, k=kb,
                karatsuba=cfg.swm.karatsuba)
        return [m[n](x, params={"w": w[n]}) for n in ("q", "k", "v")]

    def _cache_heads(self, cache) -> Tuple[int, int]:
        """The KV heads this rank's cache shard holds: all of them, or its
        share along the ``model`` axis (``launch.specs.cache_shardings``
        splits them when the axis divides them)."""
        axis, n = self.tp.axis, self.cfg.n_kv_heads
        held = cache["k"].shape[2]
        if held == n:
            return 0, n
        if held * axis.size == n:
            return axis.index * held, (axis.index + 1) * held
        raise ValueError(f"cache shard of {held} KV heads: neither the "
                         f"{n} heads nor a 1/{axis.size} share of them")

    def _forward_tp(self, x, positions, kv_positions=None, cache=None):
        """Self-attention on this rank's share (``self.tp``): the query
        heads ``tp.heads`` against the KV heads ``tp.kv_heads``; the output
        is ``o``'s sum over the ``model`` axis. With a cache, the rank
        writes the KV heads its cache shard holds (``_cache_heads``),
        whatever its tables' layout: when those are all the heads and its
        tables hold a part, K/V are all-gathered first. Decode reads its
        KV heads back from the shard."""
        cfg, lay, m = self.cfg, self.tp, self._modules
        axis = lay.axis
        B, S, _ = x.shape
        hd, group = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
        (h0, h1), (g0, g1) = lay.heads, lay.kv_heads
        c0, c1 = (g0, g1) if cache is None else self._cache_heads(cache)
        if not c0 <= g0 < g1 <= c1:
            raise NotImplementedError(
                f"{cfg.name}: this rank's queries read KV heads {(g0, g1)} "
                f"and its cache shard holds {(c0, c1)}")
        x = region_input(x, axis)
        q, k, v = self._qkv_tp(x)
        if lay.q_gather:
            q = gather_along(q, axis, -1)[..., h0 * hd:h1 * hd]
        a0, a1 = lay.kv_range
        if lay.kv == "gather" or (lay.kv == "local" and c1 - c0 > g1 - g0):
            # every rank gathers alike: the layout and the cache rule are
            # the same on every rank of the axis
            k, v = (gather_along(t, axis, -1) for t in (k, v))
            a0, a1 = 0, cfg.n_kv_heads * hd
        if not a0 <= c0 * hd <= c1 * hd <= a1:
            raise NotImplementedError(
                f"{cfg.name}: this rank's K/V features {(a0, a1)} do not "
                f"cover its cache's KV heads {(c0, c1)}")
        k, v = (t[..., c0 * hd - a0:c1 * hd - a0] for t in (k, v))
        nh, nc = h1 - h0, c1 - c0
        q = q.reshape(B, S, nh, hd)
        k = k.reshape(B, S, nc, hd)
        v = v.reshape(B, S, nc, hd)
        if cfg.qk_norm:
            q = m["q_norm"](q, region_input(m["q_norm"]._buffers["scale"],
                                            axis))
            k = m["k_norm"](k, region_input(m["k_norm"]._buffers["scale"],
                                            axis))
        rope = rotary(positions, hd, self.rope_theta)
        q = apply_rope(q, *rope)
        if kv_positions is not None:
            rope = rotary(kv_positions, hd, self.rope_theta)
        k = apply_rope(k, *rope)
        kv_pos = positions if kv_positions is None else kv_positions
        if cache is not None:
            cache = self._write_cache(cache, k, v, positions)
            if S == 1 or S < cache["k"].shape[1]:
                # decode / short append: attend over the cache
                k, v = (cache[n].to(x.dtype) for n in ("k", "v"))
                kv_pos = cache["pos"]
        k, v = (t[:, :, g0 - c0:g1 - c0] for t in (k, v))
        nk = g1 - g0
        if h0 % group == 0 and h1 % group == 0:
            qg = q.reshape(B, S, nk, group, hd)
        else:
            # the heads do not cover whole groups: each query head takes
            # its KV head, one group of one
            idx = torch.tensor([h // group - g0 for h in range(h0, h1)],
                               device=k.device)
            k, v = k[:, :, idx], v[:, :, idx]
            qg = q.reshape(B, S, nh, 1, hd)
        out = self._attend(qg, k, v, positions, kv_pos,
                           self.causal).reshape(B, S, nh * hd)
        if lay.q_gather:
            q0, q1 = lay.q_range
            out = out[..., q0 - h0 * hd:q1 - h0 * hd]
        return m["o"](out), cache

    @staticmethod
    def _write_cache(cache, k, v, positions):
        """Ring-buffer write at slot = pos % cache_len, in place. A span
        longer than the cache writes only its trailing cache_len tokens."""
        B, S = positions.shape
        cache_len = cache["k"].shape[1]
        if S >= cache_len:
            k, v = k[:, -cache_len:], v[:, -cache_len:]
            positions = positions[:, -cache_len:]
        slots = torch.remainder(positions, cache_len).long()
        bidx = torch.arange(B, device=positions.device)[:, None]
        cache["k"][bidx, slots] = k.to(cache["k"].dtype)
        cache["v"][bidx, slots] = v.to(cache["v"].dtype)
        cache["pos"][bidx, slots] = positions.to(torch.int32)
        return cache
