"""Optimizers: AdamW (configurable moment dtype) and Adafactor (factored v).

State trees mirror the param tree leaf for leaf, so the sharding rule
tables apply leaf for leaf (``dist.sharding.opt_shardings`` adds the ZeRO-1
data axis); the ``*_state_specs`` builders give the moments as ParamSpec
trees, with the axes the reference derives, without allocating. The math
is the reference's, in f32, with params and moments cast back to their
storage dtype; unlike the reference's pure functions, the updates write
params, moments and (for clipping) grads in place, so a step allocates no
second copy of the model. ``adamw_leaf`` / ``adafactor_leaf`` update one
leaf, so the data-parallel step can run them on this rank's slices.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig, torch_dtype
from repro_torch.nn.module import ParamSpec, map_specs, tree_leaves, tree_map

__all__ = ["adamw_state_specs", "adamw_init", "adamw_update", "adamw_consts",
           "adamw_leaf", "adafactor_state_specs", "adafactor_init",
           "adafactor_update", "adafactor_consts", "adafactor_leaf",
           "lr_schedule", "global_norm", "clip_by_global_norm"]

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


def lr_schedule(tcfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%; a 0-d f32 tensor."""
    step = _f32(step)
    warm = torch.clamp(step / max(1, tcfg.warmup_steps), max=1.0)
    t = torch.clamp((step - tcfg.warmup_steps)
                    / max(1, tcfg.total_steps - tcfg.warmup_steps), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * t))
    return tcfg.learning_rate * warm * cos


def adamw_state_specs(param_specs, tcfg: TrainConfig):
    """Moment ParamSpecs mirroring the params: the param's shape and axes
    at ``tcfg.moment_dtype``."""
    mdt = torch_dtype(tcfg.moment_dtype)

    def mom(path, s: ParamSpec):
        return ParamSpec(s.shape, mdt, init="zeros", axes=s.axes)

    return {"m": map_specs(mom, param_specs),
            "v": map_specs(mom, param_specs)}


def adamw_init(params, tcfg: TrainConfig):
    mdt = torch_dtype(tcfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.copy_(g.float() * scale)
    return grads, norm


@torch.no_grad()
def adamw_update(params, grads, opt, step: int, tcfg: TrainConfig):
    """One AdamW step, in place. Returns (params, opt)."""
    consts = adamw_consts(step, tcfg)
    for p, g, m, v in zip(*(tree_leaves(x) for x in (
            params, grads, opt["m"], opt["v"]))):
        adamw_leaf(p, g, m, v, consts, tcfg)
    return params, opt


def adamw_consts(step: int, tcfg: TrainConfig):
    """(lr, c1, c2) of one AdamW step, as Python floats."""
    t = _f32(step + 1)
    return (float(lr_schedule(tcfg, step)),
            float(1.0 - _f32(tcfg.b1) ** t),
            float(1.0 - _f32(tcfg.b2) ** t))


@torch.no_grad()
def adamw_leaf(p, g, m, v, consts, tcfg: TrainConfig) -> None:
    """AdamW on one leaf (or one slice of it: element for element the same
    math), in place."""
    lr, c1, c2 = consts
    b1, b2, eps, wd = tcfg.b1, tcfg.b2, tcfg.eps, tcfg.weight_decay
    g32 = g.float()
    m32 = m.float() * b1 + g32 * (1 - b1)
    v32 = v.float() * b2 + g32.square() * (1 - b2)
    p32 = p.float()
    new_p = p32 - lr * ((m32 / c1) / (torch.sqrt(v32 / c2) + eps)
                        + wd * p32)
    p.copy_(new_p)
    m.copy_(m32)
    v.copy_(v32)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moment: for a
# (…, r, c) parameter, row/col accumulators of size O(r + c).
# ---------------------------------------------------------------------------


def adafactor_state_specs(param_specs, tcfg: TrainConfig):
    """Factored-moment ParamSpecs: ``vr`` drops the last dim, ``vc`` the
    second-to-last (a 1-d param keeps its shape in ``vr`` and a (1,)
    ``vc``), each keeping the remaining dims' axes."""
    def vr(path, s):
        if len(s.shape) >= 2:
            return ParamSpec(s.shape[:-1], _F32, init="zeros",
                             axes=s.axes[:-1])
        return ParamSpec(s.shape, _F32, init="zeros", axes=s.axes)

    def vc(path, s):
        if len(s.shape) >= 2:
            return ParamSpec(s.shape[:-2] + s.shape[-1:], _F32, init="zeros",
                             axes=s.axes[:-2] + s.axes[-1:])
        return ParamSpec((1,), _F32, init="zeros", axes=(None,))

    return {"vr": map_specs(vr, param_specs),
            "vc": map_specs(vc, param_specs)}


def adafactor_init(params, tcfg: TrainConfig):
    def vr(p):
        return torch.zeros(p.shape[:-1] if p.dim() >= 2 else p.shape,
                           dtype=_F32, device=p.device)

    def vc(p):
        return torch.zeros(p.shape[:-2] + p.shape[-1:] if p.dim() >= 2
                           else (1,), dtype=_F32, device=p.device)

    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params)}


@torch.no_grad()
def adafactor_update(params, grads, opt, step: int, tcfg: TrainConfig):
    """Factored RMS update (no first moment), decay 1 - t^-0.8, update
    clipping at RMS 1.0, weight decay as in AdamW; in place. Returns
    (params, opt)."""
    consts = adafactor_consts(step, tcfg)
    for p, g, vr, vc in zip(*(tree_leaves(x) for x in (
            params, grads, opt["vr"], opt["vc"]))):
        adafactor_leaf(p, g, vr, vc, consts, tcfg)
    return params, opt


def adafactor_consts(step: int, tcfg: TrainConfig):
    """(lr, beta2) of one Adafactor step, as Python floats."""
    return (float(lr_schedule(tcfg, step)),
            float(1.0 - _f32(step + 1) ** -0.8))


@torch.no_grad()
def adafactor_leaf(p, g, vr, vc, consts, tcfg: TrainConfig) -> None:
    """Adafactor on one whole leaf, in place (its row/column means and
    update RMS span the leaf, so it takes no slices)."""
    lr, beta2 = consts
    eps = 1e-30
    wd = tcfg.weight_decay
    g32 = g.float()
    g2 = g32.square() + eps
    if p.dim() >= 2:
        vr_n = beta2 * vr + (1 - beta2) * g2.mean(-1)
        vc_n = beta2 * vc + (1 - beta2) * g2.mean(-2)
        denom = (vr_n[..., :, None] * vc_n[..., None, :]
                 / torch.clamp(vr_n.mean(-1)[..., None, None], min=eps))
        upd = g32 * torch.rsqrt(denom + eps)
    else:
        vr_n = beta2 * vr + (1 - beta2) * g2
        vc_n = vc
        upd = g32 * torch.rsqrt(vr_n + eps)
    rms = torch.sqrt(upd.square().mean() + eps)
    upd = upd / torch.clamp(rms, min=1.0)
    p32 = p.float()
    p.copy_(p32 - lr * (upd + wd * p32))
    vr.copy_(vr_n)
    vc.copy_(vc_n)
