"""RWKV-6 "Finch" — attention-free mixer with data-dependent decay.

The reference's ``repro.nn.rwkv``: the r/k/v/g/o and channel-mix
projections are weight GEMMs (families ``attn`` and ``ffn``, so they run
the ``bc_matmul`` kernel on the kernel impl); the token shift, the ddlerp
mixes, the decay LoRA and the WKV recurrence are not weight matrices and
stay in plain PyTorch, as the reference left them to XLA.

State per layer: the token-shift last x of the time mix and of the channel
mix, and the per-head f32 ``(hd, hd)`` WKV matrix: O(1) in sequence
length. The cache, when given, is updated in place.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
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


def _shifted(x, cache, key, mask):
    prev = _token_shift(x, None if cache is None else cache[key])
    if mask is not None:
        prev = torch.where(_prev_valid(mask)[..., None], prev,
                           torch.zeros_like(prev))
    return prev


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
        m, b = self._modules, self._buffers
        B, S, d = x.shape
        H, hd = self.n_heads, cfg.rwkv_head_dim

        prev = _shifted(x, cache, "shift_att", mask)
        dx = (prev - x).float()
        xf = x.float()

        # data-dependent token-shift mix (Finch ddlerp)
        xx = xf + dx * b["mu_x"]
        lora = torch.tanh(xx @ b["mix_A"]).reshape(B, S, 5, -1)
        mix = b["mu"] + torch.einsum("bsfm,fmd->bsfd", lora, b["mix_B"])
        xs = xf[:, :, None, :] + dx[:, :, None, :] * mix    # (B, S, 5, d)
        xw, xk, xv, xr, xg = [xs[:, :, i].to(x.dtype) for i in range(5)]

        # data-dependent decay in (0, 1)
        ww = b["w0"] + torch.tanh(xw.float() @ b["w_A"]) @ b["w_B"]
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
        y = ys.transpose(0, 1).reshape(B, S, d)              # f32

        # per-head group norm, then the gate
        yh = y.reshape(B, S, H, hd)
        mu = yh.mean(dim=-1, keepdim=True)
        var = yh.var(dim=-1, keepdim=True, correction=0)
        yh = (yh - mu) * torch.rsqrt(var + _GN_EPS)
        y = yh.reshape(B, S, d) * b["ln_scale"] + b["ln_bias"]
        y = y.to(x.dtype) * F.silu(g)
        out = m["o"](y)
        if cache is not None:
            cache["shift_att"].copy_(x[:, -1, :])
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
        prev = _shifted(x, cache, "shift_ffn", mask)
        dx = (prev - x).float()
        xf = x.float()
        xk = (xf + dx * b["mu_k"]).to(x.dtype)
        xr = (xf + dx * b["mu_r"]).to(x.dtype)
        k = torch.square(F.relu(m["wk"](xk)))
        r = torch.sigmoid(m["wr"](xr))
        y = r * m["wv"](k)
        if cache is not None:
            cache["shift_ffn"].copy_(x[:, -1, :])
        return y, cache
