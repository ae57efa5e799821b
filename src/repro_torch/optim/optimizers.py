"""Optimizers: AdamW (configurable moment dtype) and Adafactor (factored v).

State trees mirror the param tree leaf for leaf, so the sharding rule
tables apply leaf for leaf (``dist.sharding.opt_shardings`` adds the ZeRO-1
data axis); the ``*_state_specs`` builders give the moments as ParamSpec
trees, with the axes the reference derives, without allocating. The math
is the reference's, in f32, with params and moments cast back to their
storage dtype; unlike the reference's pure functions, the updates write
params, moments and (for clipping) grads in place, so a step allocates no
second copy of the model. ``adamw_leaf`` updates one leaf, so the
data-parallel step can run it on this rank's slices; ``adafactor_group``
updates one leaf, or the per-layer leaves of one repeated-layer stack, as
a whole (its means and RMS span the stack).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig, torch_dtype
from repro_torch.nn.module import ParamSpec, map_specs, tree_leaves, tree_map

__all__ = ["adamw_state_specs", "adamw_init", "adamw_update", "adamw_consts",
           "adamw_leaf", "adafactor_state_specs", "adafactor_init",
           "adafactor_update", "adafactor_consts", "adafactor_group",
           "adafactor_groups",
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


def global_norm(tree, counted=None, reduce=None) -> torch.Tensor:
    """The L2 norm over every leaf of ``tree``. On a mesh whose leaves are
    this rank's shards, ``counted`` (a bool per leaf) names the leaves this
    rank adds, so that each element of the whole tree is counted once
    (``dist.tensor_parallel.norm_owner``), and ``reduce`` sums the ranks'
    squares."""
    leaves = tree_leaves(tree)
    if counted is None:
        return torch.sqrt(sum(x.float().square().sum() for x in leaves))
    sq = torch.zeros((), dtype=_F32, device=leaves[0].device)
    for x, c in zip(leaves, counted):
        if c:
            sq = sq + x.float().square().sum()
    return torch.sqrt(reduce(sq) if reduce is not None else sq)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, counted=None, reduce=None):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping). ``counted`` / ``reduce``
    take a sharded tree's norm (:func:`global_norm`)."""
    norm = global_norm(grads, counted, reduce)
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
#
# The reference stacks every leaf of a repeated layer group on a leading
# layer axis and updates the stack as one leaf; the port keeps one leaf per
# layer. ``stacks`` (``convert.layer_stacks(cfg)``: tuples of the subtree
# paths the reference stacks) makes the port update each stacked set of
# per-layer leaves as the reference updates their stack: a 1-d per-layer
# leaf (a norm scale) is factored across the layers, its ``vr`` one entry
# per layer (a 0-d leaf per layer) and its ``vc`` the stack's ``(d,)``
# column moment, held as an equal copy by every layer's leaf; leaves of 2
# or more dims keep their per-layer ``vr``/``vc`` (the stack's slices);
# and the relative-update clip takes its RMS over the whole stack.
# ---------------------------------------------------------------------------


def _leaf_paths(tree, path=()):
    """(path, leaf) pairs in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (k,))
    else:
        yield path, tree


def _stacked(path, stacks) -> bool:
    return any(path[:len(pre)] == tuple(pre)
               for stack in stacks for pre in stack)


def _moment_shapes(shape, stacked: bool):
    """(vr, vc) shapes of a leaf of ``shape``: the reference's for a plain
    leaf; for one layer's leaf of a stack, the stack's moments without
    the layer axis (a shared ``vc`` keeps its whole shape)."""
    shape = tuple(shape)
    if stacked:
        if not shape:
            return (), (1,)
        return shape[:-1], shape[:-2] + shape[-1:]
    if len(shape) >= 2:
        return shape[:-1], shape[:-2] + shape[-1:]
    return shape, (1,)


def adafactor_state_specs(param_specs, tcfg: TrainConfig, stacks=()):
    """Factored-moment ParamSpecs: ``vr`` drops the last dim, ``vc`` the
    second-to-last (a 1-d param keeps its shape in ``vr`` and a (1,)
    ``vc``), each keeping the remaining dims' axes; a leaf in ``stacks``
    takes its stack's moments without the layer axis (``vr`` () and
    ``vc`` (d,) for a 1-d leaf)."""
    def vr(path, s):
        shape = _moment_shapes(s.shape, _stacked(path, stacks))[0]
        return ParamSpec(shape, _F32, init="zeros",
                         axes=s.axes[:len(shape)])

    def vc(path, s):
        stacked = _stacked(path, stacks)
        shape = _moment_shapes(s.shape, stacked)[1]
        factored = len(s.shape) >= 2 or (stacked and len(s.shape) == 1)
        return ParamSpec(shape, _F32, init="zeros",
                         axes=s.axes[:-2] + s.axes[-1:] if factored
                         else (None,))

    return {"vr": map_specs(vr, param_specs),
            "vc": map_specs(vc, param_specs)}


def adafactor_init(params, tcfg: TrainConfig, stacks=()):
    """Zero moments of the shapes :func:`adafactor_state_specs` gives."""
    def make(key):
        def rec(tree, path=()):
            if isinstance(tree, dict):
                return {k: rec(v, path + (k,)) for k, v in tree.items()}
            shape = _moment_shapes(tree.shape, _stacked(path, stacks))[key]
            return torch.zeros(shape, dtype=_F32, device=tree.device)
        return rec(params)

    return {"vr": make(0), "vc": make(1)}


def adafactor_groups(params, stacks=()):
    """Lists of leaf indices (:func:`tree_leaves` order) updated together:
    one per leaf of a layer of each stack, holding that leaf of every
    layer of the stack; every other leaf alone. Returns
    ``[(indices, stacked)]``."""
    paths = [p for p, _ in _leaf_paths(params)]
    index = {p: i for i, p in enumerate(paths)}
    out, seen = [], set()
    for stack in stacks:
        pres = [tuple(pre) for pre in stack]
        n = len(pres[0])
        for path in paths:
            if path[:n] != pres[0]:
                continue
            idx = [index[pre + path[n:]] for pre in pres]
            out.append((idx, True))
            seen.update(idx)
    out += [([i], False) for i in range(len(paths)) if i not in seen]
    return out


@torch.no_grad()
def adafactor_update(params, grads, opt, step: int, tcfg: TrainConfig,
                     stacks=()):
    """Factored RMS update (no first moment), decay 1 - t^-0.8, update
    clipping at RMS 1.0, weight decay as in AdamW; in place, each group of
    :func:`adafactor_groups` as one leaf. Returns (params, opt)."""
    consts = adafactor_consts(step, tcfg)
    trees = [tree_leaves(x) for x in (params, grads, opt["vr"], opt["vc"])]
    for idx, stacked in adafactor_groups(params, stacks):
        adafactor_group(*([t[i] for i in idx] for t in trees), consts, tcfg,
                        stacked=stacked)
    return params, opt


def adafactor_consts(step: int, tcfg: TrainConfig):
    """(lr, beta2) of one Adafactor step, as Python floats."""
    return (float(lr_schedule(tcfg, step)),
            float(1.0 - _f32(step + 1) ** -0.8))


_EPS = 1e-30


def _factored(g32, vr, vc, beta2):
    """The reference's factored step on one array of 2 or more dims:
    (update before clipping, vr, vc)."""
    g2 = g32.square() + _EPS
    vr_n = beta2 * vr + (1 - beta2) * g2.mean(-1)
    vc_n = beta2 * vc + (1 - beta2) * g2.mean(-2)
    denom = (vr_n[..., :, None] * vc_n[..., None, :]
             / torch.clamp(vr_n.mean(-1)[..., None, None], min=_EPS))
    return g32 * torch.rsqrt(denom + _EPS), vr_n, vc_n


def _unfactored(g32, vr, beta2):
    vr_n = beta2 * vr + (1 - beta2) * (g32.square() + _EPS)
    return g32 * torch.rsqrt(vr_n + _EPS), vr_n


@torch.no_grad()
def adafactor_group(ps, gs, vrs, vcs, consts, tcfg: TrainConfig,
                    stacked: bool = False) -> None:
    """Adafactor on one leaf (``stacked=False``, lists of one) or on the
    per-layer leaves of one stack, as the reference updates the stacked
    leaf; in place. Row/column means and the update RMS span the whole
    leaf or stack, so it takes no slices."""
    lr, beta2 = consts
    for p, vr, vc in zip(ps, vrs, vcs):
        want = _moment_shapes(p.shape, stacked)
        if (tuple(vr.shape), tuple(vc.shape)) != want:
            raise ValueError(
                f"Adafactor moments {tuple(vr.shape)}/{tuple(vc.shape)} do "
                f"not fit a {'stacked ' if stacked else ''}leaf of shape "
                f"{tuple(p.shape)} (want {want[0]}/{want[1]}): make the "
                f"state with the same stacks= the step uses")
    if stacked and ps[0].dim() <= 1:
        # factored (1-d per layer) or unfactored (0-d) across the stack
        g32 = torch.stack([g.float() for g in gs])
        if ps[0].dim() == 1:
            upd, vr_n, vc_n = _factored(g32, torch.stack(vrs), vcs[0], beta2)
        else:
            (upd, vr_n), vc_n = _unfactored(g32, torch.stack(vrs), beta2), \
                vcs[0]
        upds = list(upd)
        vr_new = list(vr_n)
        vc_new = [vc_n] * len(ps)
    else:
        upds, vr_new, vc_new = [], [], []
        for g, vr, vc in zip(gs, vrs, vcs):
            g32 = g.float()
            if g32.dim() >= 2:
                u, a, b = _factored(g32, vr, vc, beta2)
            else:
                (u, a), b = _unfactored(g32, vr, beta2), vc
            upds.append(u)
            vr_new.append(a)
            vc_new.append(b)
    n = sum(u.numel() for u in upds)
    rms = torch.sqrt(sum(u.square().sum() for u in upds) / n + _EPS)
    scale = torch.clamp(rms, min=1.0)
    for p, u, vr, vc, a, b in zip(ps, upds, vrs, vcs, vr_new, vc_new):
        p32 = p.float()
        p.copy_(p32 - lr * (u / scale + tcfg.weight_decay * p32))
        vr.copy_(a)
        vc.copy_(b)
