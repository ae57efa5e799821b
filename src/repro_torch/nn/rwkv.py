"""RWKV-6 "Finch" — attention-free mixer with data-dependent decay.

The reference's ``repro.nn.rwkv``: the r/k/v/g/o and channel-mix
projections are weight GEMMs (families ``attn`` and ``ffn``, so they run
the ``bc_matmul`` kernel on the kernel impl); the token shift, the ddlerp
mixes, the decay LoRA and the WKV recurrence are not weight matrices and
stay in plain PyTorch, as the reference left them to XLA.

State per layer: the token-shift last x of the time mix and of the channel
mix, and the per-head f32 ``(hd, hd)`` WKV matrix: O(1) in sequence
length. The cache, when given, is updated in place.

Under tensor parallelism (set by ``dist.tensor_parallel.shard_model`` when
``heads`` and ``mlp`` are split over ``model``) the time mix's ``tp`` is a
``dist.tensor_parallel.RWKVLayout``: x and every leaf the rules leave
whole (the mixes, the LoRAs, ``w0``, the group norm's scale and bias)
enter the region, since each rank uses only its channels' share of what
they give; the decay is computed for the rank's channels only; r, k, v
and g are column-parallel and give the rank's heads, ``u`` holds them, and
the WKV scan, the group norm and the gate run per head; ``o`` sums the
partial outputs into the residual. The channel mix's ``tp`` is the
``model`` axis: the region starts at ``xk`` and nowhere else (``r`` is
computed whole on every rank and multiplies the summed ``wv`` output, so
its gradient is whole already), ``wk`` is column- and ``wv`` row-parallel.
Served with a cache split over ``model``, the shift states hold the rank's
channels and are all-gathered at each step (``cache_axis``), of which the
rank writes back its own; the WKV state holds the rank's heads.
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

__all__ = ["RWKV6TimeMix", "RWKV6ChannelMix", "init_rwkv_cache"]

# the per-head group norm's epsilon (the reference's 64e-5)
_GN_EPS = 64e-5


def init_rwkv_cache(batch: int, d_model: int, n_heads: int, head_dim: int,
                    dtype, device):
    """Empty state, slot axis 0."""
    return {
        "shift_att": torch.zeros((batch, d_model), dtype=dtype,
                                 device=device),
        "shift_ffn": torch.zeros((batch, d_model), dtype=dtype,
                                 device=device),
        "wkv": torch.zeros((batch, n_heads, head_dim, head_dim),
                           dtype=torch.float32, device=device),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """x (B, S, d) -> the previous token's x; ``last`` (B, d) carries
    across calls (zeros before the first token)."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None, :], x[:, :-1]], dim=1)


def _prev_valid(mask: torch.Tensor) -> torch.Tensor:
    """Validity of each position's *previous* token under a (B, S) mask:
    True at t = 0 (the carried ``last`` is the legitimate previous token;
    zeros for a fresh cache, as in an unpadded run), ``mask[:, t-1]``
    after. A left-pad lane's x never enters a real token's shift mix."""
    return F.pad(mask[:, :-1], (1, 0), value=True)


def _shifted(x, cache, key, mask, axis=None):
    """The previous token's x under ``mask``; a cache that holds this
    rank's channels of the carried x only is all-gathered over ``axis``
    (no gradient: the cache carries none)."""
    last = None if cache is None else cache[key]
    if last is not None and last.shape[-1] != x.shape[-1]:
        last = gather_along(last, axis, -1)
    prev = _token_shift(x, last)
    if mask is not None:
        prev = torch.where(_prev_valid(mask)[..., None], prev,
                           torch.zeros_like(prev))
    return prev


def _keep_last(cache, key, x, axis=None) -> None:
    """Write x's last position into the cache's ``key``: this rank's
    channels of it when the cache holds a split over ``axis``."""
    state = cache[key]
    last, n = x[:, -1, :], state.shape[-1]
    if n != x.shape[-1]:
        last = last[:, axis.index * n:(axis.index + 1) * n]
    state.copy_(last)


# the time mix's leaves that the rules leave whole on a 'model' axis
_WHOLE = ("mu_x", "mu", "mix_A", "mix_B", "w0", "w_A", "w_B", "ln_scale",
          "ln_bias")


class RWKV6TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(swm=cfg.swm, dtype=cfg.param_dtype)
        for name in ("r", "k", "v", "g"):
            self.add_module(name, Linear(d, d, family="attn", in_axis="embed",
                                         out_axis="heads", **kw))
        self.add_module("o", Linear(d, d, family="attn", in_axis="heads",
                                    out_axis="embed", **kw))
        # set on a mesh by dist.tensor_parallel.shard_model
        self.tp, self.cache_axis = None, None

    @property
    def n_heads(self) -> int:
        return self.cfg.d_model // self.cfg.rwkv_head_dim

    def specs(self):
        cfg = self.cfg
        d, H, hd = cfg.d_model, self.n_heads, cfg.rwkv_head_dim
        dl, ml = cfg.rwkv_decay_lora, cfg.rwkv_mix_lora
        f32 = torch.float32
        out = {
            "mu_x": ParamSpec((d,), f32, init="uniform", scale=0.5,
                              axes=(None,)),
            "mu": ParamSpec((5, d), f32, init="uniform", scale=0.5,
                            axes=(None, None)),
            "mix_A": ParamSpec((d, 5 * ml), f32, scale=d ** -0.5,
                               axes=(None, None)),
            "mix_B": ParamSpec((5, ml, d), f32, scale=ml ** -0.5,
                               axes=(None, None, None)),
            "w0": ParamSpec((d,), f32, init="uniform", scale=1.0,
                            axes=(None,)),
            "w_A": ParamSpec((d, dl), f32, scale=d ** -0.5,
                             axes=(None, None)),
            "w_B": ParamSpec((dl, d), f32, scale=dl ** -0.5,
                             axes=(None, None)),
            "u": ParamSpec((H, hd), f32, init="uniform", scale=0.5,
                           axes=("heads", None)),
            "ln_scale": ParamSpec((d,), f32, init="ones", axes=(None,)),
            "ln_bias": ParamSpec((d,), f32, init="zeros", axes=(None,)),
        }
        for name in ("r", "k", "v", "g", "o"):
            out[name] = self._modules[name].specs()
        return out

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                mask: Optional[torch.Tensor] = None):
        """``mask`` (B, S) bool marks valid (non-pad) positions: pad x
        never enters a token shift and the WKV state skips pad steps, so a
        left-padded bucketed prefill matches the unpadded B = 1 run.
        Returns (y, cache)."""
        cfg = self.cfg
        m = self._modules
        B, S, d = x.shape
        hd = cfg.rwkv_head_dim
        axis = None if self.tp is None else self.tp.axis
        c0, c1 = (0, d) if self.tp is None else self.tp.channels
        H = (c1 - c0) // hd                      # this rank's heads
        # x and the whole leaves enter the region: each rank's gradient of
        # them is a partial (its channels' share)
        x = region_input(x, axis)
        b = dict(self._buffers)
        b.update((n, region_input(b[n], axis)) for n in _WHOLE)

        prev = _shifted(x, cache, "shift_att", mask, self.cache_axis)
        dx = (prev - x).float()
        xf = x.float()

        # data-dependent token-shift mix (Finch ddlerp)
        xx = xf + dx * b["mu_x"]
        lora = torch.tanh(xx @ b["mix_A"]).reshape(B, S, 5, -1)
        mix = b["mu"] + torch.einsum("bsfm,fmd->bsfd", lora, b["mix_B"])
        xs = xf[:, :, None, :] + dx[:, :, None, :] * mix    # (B, S, 5, d)
        xw, xk, xv, xr, xg = [xs[:, :, i].to(x.dtype) for i in range(5)]

        # data-dependent decay in (0, 1), of this rank's channels
        ww = b["w0"][c0:c1] + torch.tanh(
            xw.float() @ b["w_A"]) @ b["w_B"][:, c0:c1]
        w = torch.exp(-torch.exp(ww.float()))

        r = m["r"](xr).reshape(B, S, H, hd)
        k = m["k"](xk).reshape(B, S, H, hd)
        v = m["v"](xv).reshape(B, S, H, hd)
        g = m["g"](xg)
        u = b["u"]
        s0 = (cache["wkv"] if cache is not None
              else torch.zeros((B, H, hd, hd), dtype=torch.float32,
                               device=x.device))

        def step(s, t):
            r_t, k_t, v_t, w_t = t[:4]                       # (B, H, hd)
            kv = k_t[..., :, None] * v_t[..., None, :]       # (B, H, hd, hd)
            y = (torch.einsum("bhk,bhkv->bhv", r_t * u[None], kv)
                 + torch.einsum("bhk,bhkv->bhv", r_t, s))
            s_new = w_t[..., :, None] * s + kv
            if mask is not None:
                # pad steps leave the state untouched, decay included
                s_new = torch.where(t[4][:, None, None, None], s_new, s)
            return s_new, y

        ts = tuple(a.float().transpose(0, 1)
                   for a in (r, k, v, w.reshape(B, S, H, hd)))
        if mask is not None:
            ts = ts + (mask.transpose(0, 1),)
        sT, ys = chunked_time_scan(step, s0, ts, chunk=256, remat=S > 256)
        y = ys.transpose(0, 1).reshape(B, S, H * hd)         # f32

        # per-head group norm, then the gate
        yh = y.reshape(B, S, H, hd)
        mu = yh.mean(dim=-1, keepdim=True)
        var = yh.var(dim=-1, keepdim=True, correction=0)
        yh = (yh - mu) * torch.rsqrt(var + _GN_EPS)
        y = (yh.reshape(B, S, H * hd) * b["ln_scale"][c0:c1]
             + b["ln_bias"][c0:c1])
        y = y.to(x.dtype) * F.silu(g)
        out = m["o"](y)                # row-parallel: summed over 'model'
        if cache is not None:
            _keep_last(cache, "shift_att", x, self.cache_axis)
            cache["wkv"].copy_(sT)
        return out, cache


class RWKV6ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, dff = cfg.d_model, cfg.d_ff
        kw = dict(family="ffn", swm=cfg.swm, dtype=cfg.param_dtype)
        self.add_module("wk", Linear(d, dff, in_axis="embed", out_axis="mlp",
                                     **kw))
        self.add_module("wr", Linear(d, d, in_axis="embed", **kw))
        self.add_module("wv", Linear(dff, d, in_axis="mlp", out_axis="embed",
                                     **kw))
        # set on a mesh by dist.tensor_parallel.shard_model
        self.tp, self.cache_axis = None, None

    def specs(self):
        d = self.cfg.d_model
        f32 = torch.float32
        out = {"mu_k": ParamSpec((d,), f32, init="uniform", scale=0.5,
                                 axes=(None,)),
               "mu_r": ParamSpec((d,), f32, init="uniform", scale=0.5,
                                 axes=(None,))}
        for name in ("wk", "wr", "wv"):
            out[name] = self._modules[name].specs()
        return out

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                mask: Optional[torch.Tensor] = None):
        """``mask`` as in :class:`RWKV6TimeMix`: pad positions never enter
        the channel-mix token shift. Returns (y, cache)."""
        m, b = self._modules, self._buffers
        prev = _shifted(x, cache, "shift_ffn", mask, self.cache_axis)
        dx = (prev - x).float()
        xf = x.float()
        xk = (xf + dx * b["mu_k"]).to(x.dtype)
        xr = (xf + dx * b["mu_r"]).to(x.dtype)
        # the region starts at xk only: r is whole on every rank and
        # multiplies wv's summed output, so its gradient is whole already
        k = torch.square(F.relu(m["wk"](region_input(xk, self.tp))))
        r = torch.sigmoid(m["wr"](xr))
        y = r * m["wv"](k)             # row-parallel: summed over 'model'
        if cache is not None:
            _keep_last(cache, "shift_ffn", x, self.cache_axis)
        return y, cache
