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
set by ``shard_model``; self and cross attention, in training and
serving) the layer computes the query heads its q blocks touch: x enters
the region once, q/k/v come from this rank's column blocks (self
attention: one fused launch whose splits are local, time-domain or frozen
tables; cross attention: q from x, k and v from the encoder output, which
enters the region too, one launch each), its K/V are its own blocks, the
all-gathered blocks cut to the KV heads its query heads read, or (whole
tables, entering the region so that their gradient partials are summed)
the whole K/V cut the same way; qk-norm scales enter the region too.
``o`` holds the input blocks of exactly the query features this rank
produced and sums the partial outputs.

A serving rank's cache shard holds what ``launch.specs.cache_shardings``
gives it, whatever its tables' layout, and every layer on a ``model``
axis (``cache_axis``), a replicated one (q whole) too, writes exactly
that: its share of the KV heads when the axis divides them, else all of
them (K/V all-gathered first when its tables hold a part); or, for a
cross cache split on its frames (``frames_split``), its slice of the
frames of every head. Over such a slice the rank attends every query head
(gathered), keeping the online softmax's partials (row max, sum of
exponentials, unnormalised output), and the ranks' partials are combined
with two all-reduces (:func:`_combine_partials`): O(batch·d_model) per
decode step and layer, not O(cache). A replicated layer over a head-split
cache attends its query heads over its KV heads and all-gathers the
outputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import circulant as circ
from repro_torch.dist.sharding import (all_reduce_max, all_reduce_sum,
                                       gather_along, region_input)
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


def _flash_partials(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: int = 0, prefix_len: int = 0,
                    softcap: float = 0.0, q_chunk: int = 512,
                    kv_chunk: int = 1024):
    """The online softmax's state after every KV chunk, f32: the row max
    ``m`` and the sum of exponentials ``l`` (B, HKV, G, Sq) and the
    unnormalised output ``acc`` (B, HKV, G, Sq, hd)."""
    B, Sq, HKV, G, hd = q.shape
    Skv = k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    ms, ls, accs = [], [], []
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
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return torch.cat(ms, dim=3), torch.cat(ls, dim=3), torch.cat(accs, dim=3)


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: int = 0, prefix_len: int = 0,
                    softcap: float = 0.0, q_chunk: int = 512,
                    kv_chunk: int = 1024):
    """Online-softmax attention over KV chunks, O(S·chunk) memory.
    q (B, Sq, HKV, G, hd), k/v (B, Skv, HKV, hd) -> (B, Sq, HKV, G, hd)."""
    _, l, acc = _flash_partials(q, k, v, q_pos, kv_pos, causal=causal,
                                window=window, prefix_len=prefix_len,
                                softcap=softcap, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)     # (B, Sq, HKV, G, hd)


def _combine_partials(m, l, acc, axis):
    """The flash partials (:func:`_flash_partials`) of the ranks of
    ``axis``, each over its own slice of the keys, combined into the
    attention over all of them (B, Sq, HKV, G, hd), f32: the max over the
    ranks, each rank's sums rescaled to it, then summed (two all-reduces of
    O(B·Sq·heads·hd)). A rank whose keys are all masked (its max at the
    mask's -2e38) weighs zero; a row with no unmasked key anywhere comes
    out 0."""
    top = all_reduce_max(m, axis)
    w = torch.where(m > _NEG / 2, torch.exp(m - top), torch.zeros_like(m))
    both = all_reduce_sum(torch.cat([(l * w)[..., None],
                                     acc * w[..., None]], dim=-1), axis)
    out = both[..., 1:] / torch.clamp(both[..., :1], min=1e-30)
    return out.permute(0, 3, 1, 2, 4)


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
        # set on a mesh: ``tp`` by ``dist.tensor_parallel.shard_model``, the
        # ``model`` axis a cache shard is split over (``cache_axis``, every
        # layer's, replicated ones' too) with it, and ``frames_split`` by
        # ``ServeParallel.layout`` for a step whose cross cache shards hold
        # a slice of the frames
        self.tp, self.cache_axis, self.frames_split = None, None, False

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
            return self._forward_tp(x, positions, kv_positions, cache, kv_x)
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

        if cache is not None and self._split(cache):
            out = self._replicated_split(q, k, v, positions, kv_positions,
                                         cache)
            return m["o"](out), cache
        if cache is not None and self.cross:
            if k is not None:                     # prefill: stash enc K/V
                self._stash_cross(cache, k, v, kv_positions)
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

    def _split(self, cache) -> bool:
        """Whether this rank's cache shard holds a part of the layer's
        cache: a cross cache's frames (``frames_split``) or a share of the
        KV heads."""
        if self.cache_axis is None or self.cache_axis.size == 1:
            return False
        return ((self.cross and self.frames_split)
                or cache["k"].shape[2] < self.cfg.n_kv_heads)

    def _replicated_split(self, q, k, v, positions, kv_positions, cache):
        """A replicated layer (its q table whole: every query head on every
        rank) on a cache shard that holds a part (``_split``): (B, S, HQ·hd)
        attention output, the same on every rank of ``cache_axis``.

        A frame-split cross cache takes this rank's frames of the whole K/V
        at prefill and is read through the combine of the ranks' partials
        (:meth:`_attend_frames`). A cache split by KV head takes those
        heads of K/V; the rank attends its query heads over them and the
        ranks' outputs are all-gathered along the heads, except in a
        prefill covering the whole self ring, which attends every head over
        the fresh K/V."""
        cfg, axis = self.cfg, self.cache_axis
        B, S = q.shape[:2]
        hd, HKV = cfg.head_dim, cfg.n_kv_heads
        group = cfg.n_heads // HKV
        if self.cross and self.frames_split:
            if k is not None:
                self._write_frames(cache, k, v, kv_positions)
            out = self._attend_frames(q.reshape(B, S, HKV, group, hd), cache,
                                      positions)
            return out.reshape(B, S, -1).to(q.dtype)
        c0, c1 = self._cache_heads(cache)
        if self.cross:
            if k is not None:
                self._stash_cross(cache, k[:, :, c0:c1], v[:, :, c0:c1],
                                  kv_positions)
        else:
            self._write_cache(cache, k[:, :, c0:c1], v[:, :, c0:c1],
                              positions)
            if not (S == 1 or S < cache["k"].shape[1]):
                out = self._attend(q.reshape(B, S, HKV, group, hd), k, v,
                                   positions, positions, self.causal)
                return out.reshape(B, S, -1)
        qg = q[:, :, c0 * group:c1 * group].reshape(B, S, c1 - c0, group, hd)
        out = self._attend(qg, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                           positions, cache["pos"],
                           self.causal and not self.cross)
        return gather_along(out.reshape(B, S, -1), axis, -1)

    @staticmethod
    def _stash_cross(cache, k, v, kv_positions):
        """A cross cache's entries replaced by the encoder's K/V and
        positions (prefill)."""
        cache["k"] = k.to(cache["k"].dtype)
        cache["v"] = v.to(cache["v"].dtype)
        cache["pos"] = kv_positions.to(torch.int32)

    def _write_frames(self, cache, k, v, kv_positions):
        """This rank's frames of the encoder's K/V (every KV head) into its
        frame-split cross cache shard, in place: rank ``r`` of
        ``cache_axis`` holds frames ``[r·n, (r+1)·n)`` of the ``n·size``
        the whole cache has; frames past the encoder's ``T`` stay unfilled
        (pos -1, masked)."""
        axis = self.cache_axis
        n, T = cache["k"].shape[1], k.shape[1]
        if T > n * axis.size:
            raise ValueError(
                f"{T} encoder frames do not fit a cross cache of "
                f"{n * axis.size} frames split over {axis.size} ranks")
        f0 = axis.index * n
        m = max(0, min(n, T - f0))
        for name, t in (("k", k), ("v", v)):
            cache[name][:, :m] = t[:, f0:f0 + m].to(cache[name].dtype)
            cache[name][:, m:] = 0
        cache["pos"][:, :m] = kv_positions[:, f0:f0 + m].to(torch.int32)
        cache["pos"][:, m:] = -1

    def _attend_frames(self, qg, cache, positions):
        """Every query head ``qg`` (B, S, HKV, G, hd) over this rank's
        frames of a frame-split cross cache, combined with the other
        ranks' (:func:`_combine_partials`): (B, S, HKV, G, hd), f32."""
        cfg = self.cfg
        k, v = (cache[n].to(qg.dtype) for n in ("k", "v"))
        m, l, acc = _flash_partials(
            qg, k, v, positions, cache["pos"], causal=False,
            window=self.window, prefix_len=self.prefix_len,
            softcap=cfg.logit_softcap, q_chunk=cfg.flash_q_chunk,
            kv_chunk=cfg.flash_kv_chunk)
        return _combine_partials(m, l, acc, self.cache_axis)

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

    def _kv_tp(self, src):
        """Cross attention's k and v of ``src`` (the encoder output) from
        this rank's tables, one launch each (as one process launches them),
        whole time-domain tables (``replicated``) entering the region so
        that their gradient partials are summed."""
        lay, m = self.tp, self._modules
        out = []
        for n in ("k", "v"):
            p = m[n]
            if lay.kv == "replicated" and p.frozen_freq() is None:
                out.append(p(src, params={"w": region_input(p._buffers["w"],
                                                            lay.axis)}))
            else:
                out.append(p(src))
        return out

    def _cache_heads(self, cache) -> Tuple[int, int]:
        """The KV heads this rank's cache shard holds: all of them, or its
        share along the ``model`` axis (``launch.specs.cache_shardings``
        splits them when the axis divides them)."""
        axis, n = self.cache_axis, self.cfg.n_kv_heads
        held = cache["k"].shape[2]
        if held == n:
            return 0, n
        if axis is not None and held * axis.size == n:
            return axis.index * held, (axis.index + 1) * held
        raise ValueError(f"cache shard of {held} KV heads: neither the "
                         f"{n} heads nor this rank's share of them")

    def _forward_tp(self, x, positions, kv_positions=None, cache=None,
                    kv_x=None):
        """Attention on this rank's share (``self.tp``): the query heads
        ``tp.heads`` against the KV heads ``tp.kv_heads``; the output is
        ``o``'s sum over the ``model`` axis. Self attention takes q, k and
        v from ``x``; cross attention takes q from ``x`` and k, v from
        ``kv_x``, which enters the region (each rank's gradient of the
        encoder output is a partial), or from the cache in decode.

        With a cache, the rank writes the KV heads its cache shard holds
        (``_cache_heads``), whatever its tables' layout: when those are all
        the heads and its tables hold a part, K/V are all-gathered first.
        Decode reads its KV heads back from the shard. A frame-split cross
        cache (``frames_split``) takes this rank's frames of every head,
        the K/V all-gathered; the query heads are all-gathered to attend
        over them (:meth:`_attend_frames`), and the rank keeps its own
        query features of the combined output for ``o``."""
        cfg, lay, m = self.cfg, self.tp, self._modules
        axis = lay.axis
        B, S, _ = x.shape
        hd, group = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
        (h0, h1), (g0, g1) = lay.heads, lay.kv_heads
        frames = self.cross and cache is not None and self.frames_split
        if frames:
            c0, c1 = 0, cfg.n_kv_heads
        else:
            c0, c1 = (g0, g1) if cache is None else self._cache_heads(cache)
            if not c0 <= g0 < g1 <= c1:
                raise NotImplementedError(
                    f"{cfg.name}: this rank's queries read KV heads "
                    f"{(g0, g1)} and its cache shard holds {(c0, c1)}")
        x = region_input(x, axis)
        if self.cross:
            q = m["q"](x)
            k = v = None
            if kv_x is not None:
                k, v = self._kv_tp(region_input(kv_x, axis))
        else:
            q, k, v = self._qkv_tp(x)
        if frames:
            # every query head, each rank's features in axis order
            q = gather_along(q, axis, -1)
            h0, h1 = 0, cfg.n_heads
        elif lay.q_gather:
            q = gather_along(q, axis, -1)[..., h0 * hd:h1 * hd]
        nh, nc = h1 - h0, c1 - c0
        q = q.reshape(B, S, nh, hd)
        if k is not None:
            a0, a1 = lay.kv_range
            if lay.kv == "gather" or (lay.kv == "local"
                                      and c1 - c0 > g1 - g0):
                # every rank gathers alike: the layout and the cache rule
                # are the same on every rank of the axis
                k, v = (gather_along(t, axis, -1) for t in (k, v))
                a0, a1 = 0, cfg.n_kv_heads * hd
            if not a0 <= c0 * hd <= c1 * hd <= a1:
                raise NotImplementedError(
                    f"{cfg.name}: this rank's K/V features {(a0, a1)} do "
                    f"not cover its cache's KV heads {(c0, c1)}")
            T = k.shape[1]
            k, v = (t[..., c0 * hd - a0:c1 * hd - a0].reshape(B, T, nc, hd)
                    for t in (k, v))
        if cfg.qk_norm:
            q = m["q_norm"](q, region_input(m["q_norm"]._buffers["scale"],
                                            axis))
            if k is not None:
                k = m["k_norm"](k, region_input(
                    m["k_norm"]._buffers["scale"], axis))
        if not self.cross:
            rope = rotary(positions, hd, self.rope_theta)
            q = apply_rope(q, *rope)
            if kv_positions is not None:
                rope = rotary(kv_positions, hd, self.rope_theta)
            k = apply_rope(k, *rope)
        kv_pos = positions if kv_positions is None else kv_positions
        if frames:
            if k is not None:
                self._write_frames(cache, k, v, kv_positions)
            out = self._attend_frames(q.reshape(B, S, nc, group, hd), cache,
                                      positions)
            q0, q1 = lay.q_range
            return m["o"](out.reshape(B, S, -1)[..., q0:q1].to(x.dtype)), \
                cache
        if cache is not None and self.cross:
            if k is not None:
                self._stash_cross(cache, k, v, kv_positions)
            k, v = (cache[n].to(x.dtype) for n in ("k", "v"))
            kv_pos = cache["pos"]
        elif cache is not None:
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
                           self.causal and not self.cross).reshape(
                               B, S, nh * hd)
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
