"""Weights carried across: the reference's param layout <-> the port's.

The reference keeps a decoder's params as ``group{g}/l{i}/...`` with every
leaf of a repeated group stacked on a leading ``repeat`` axis; the port
keeps one module per layer under ``layers/<n>/...`` in execution order.
Leaf keys are the same in both (``w``, ``wr``, ``wi``, ``w_scale``,
``_fused``, ``scale``, ``table``, ``A_log``, ``mu``, ...). Groups of any
period carry across (jamba's 32 layers are a 6-layer group repeated once
and a 2-layer one at smoke size, an 8-layer group repeated 4 times at full
size); a MoE layer's expert axis stays inside its leaves (``(E, p, q, k)``
tables, ``(E, p, q)`` scales); top-level trees such as an untied
``lm_head`` carry over as they are. The enc-dec family's reference tree
stacks every ``encoder``/``decoder`` leaf on a leading layer axis
(``(n_enc_layers, ...)``, ``(n_layers, ...)``); the port keeps
``encoder/<n>/...`` and ``decoder/<n>/...``, and ``embed``, ``enc_norm``
and ``dec_norm`` carry over as they are.

:func:`from_reference` turns a reference tree given as nested dicts of
numpy arrays into the port's tensor tree (install it with
``nn.module.load_tree`` or pass it to ``ServeEngine``);
:func:`to_reference` exports a port tree back to the reference layout as
numpy arrays (bf16 leaves as exact float32 copies, since numpy has no
bf16), so trees can be compared leaf by leaf. The paper models keep flat
trees (nested dicts, no stacked groups); :func:`tree_from_reference` and
:func:`tree_to_reference` carry those across leaf by leaf.

:func:`layer_stacks` names the port subtrees that the reference stacks,
which Adafactor updates as stacks; :func:`opt_to_reference` and
:func:`opt_from_reference` carry an optimizer state both ways (an
Adafactor stack's shared column moment, one copy per layer in the port,
once in the reference).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.nn.module import tree_map

__all__ = ["from_reference", "to_reference", "tree_from_reference",
           "tree_to_reference", "layer_stacks", "opt_from_reference",
           "opt_to_reference"]


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _layer_slots(cfg: ModelConfig):
    """(group index, layer key, repeat index or None) per port layer, in
    execution order."""
    out = []
    for gi, group in enumerate(cfg.layer_groups()):
        for r in range(group.repeat):
            for li in range(len(group.layers)):
                out.append((gi, f"l{li}", r if group.repeat > 1 else None))
    return out


# the enc-dec family's layer stacks, each stacked on a leading layer axis
# in the reference
ENCDEC_STACKS = ("encoder", "decoder")


def _stack(subs):
    if isinstance(subs[0], dict):
        return {k: _stack([s[k] for s in subs]) for k in subs[0]}
    return np.stack(subs)


def layer_stacks(cfg: ModelConfig) -> Tuple[Tuple[Tuple[str, str], ...],
                                             ...]:
    """The port subtrees that the reference stacks on a leading layer
    axis: one tuple of ``("layers", n)`` paths per layer of a repeated
    group (``group.repeat > 1``), in stack order; the enc-dec family's
    ``encoder``/``decoder`` layers, one stack each. The optimizer updates
    each stack as the reference updates its stacked leaf
    (``optim.optimizers.adafactor_groups``)."""
    if cfg.family == "encdec":
        depths = (cfg.n_enc_layers or cfg.n_layers, cfg.n_layers)
        return tuple(tuple((name, str(i)) for i in range(n))
                     for name, n in zip(ENCDEC_STACKS, depths))
    stacks: Dict[tuple, list] = {}
    for n, (gi, lkey, r) in enumerate(_layer_slots(cfg)):
        if r is not None:
            stacks.setdefault((gi, lkey), []).append(("layers", str(n)))
    return tuple(tuple(v) for v in stacks.values())


def _ref_stacks(cfg: ModelConfig):
    """(reference subtree path, layers) of every stacked reference
    subtree."""
    if cfg.family == "encdec":
        depths = (cfg.n_enc_layers or cfg.n_layers, cfg.n_layers)
        return [((name,), n) for name, n in zip(ENCDEC_STACKS, depths)]
    return [((f"group{gi}", f"l{li}"), group.repeat)
            for gi, group in enumerate(cfg.layer_groups())
            if group.repeat > 1 for li in range(len(group.layers))]


def _map_shared(cfg: ModelConfig, vr, vc, fn):
    """The reference-layout Adafactor ``vc`` tree with ``fn(leaf, L)``
    applied to each leaf that a stack shares: the column moment of a leaf
    that is at most 1-d per layer, whose stacked ``vr`` is ``(L,)``."""
    def rec(r, c, L):
        if isinstance(c, dict):
            return {k: rec(r[k], v, L) for k, v in c.items()}
        return fn(c, L) if np.ndim(r) == 1 else c

    out = dict(vc)
    for path, L in _ref_stacks(cfg):
        node, sub_r = out, vr
        for key in path[:-1]:
            node[key] = dict(node[key])
            node, sub_r = node[key], sub_r[key]
        node[path[-1]] = rec(sub_r[path[-1]], node[path[-1]], L)
    return out


def opt_to_reference(cfg: ModelConfig, opt: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """The port's optimizer state (AdamW's ``{"m", "v"}``, or Adafactor's
    ``{"vr", "vc"}`` made with ``stacks=layer_stacks(cfg)``) -> the
    reference's layout as numpy trees: each moment tree as
    :func:`to_reference` carries params, and a stack's shared column
    moment ``(d,)`` once (every layer's leaf holds an equal copy)."""
    out = {k: to_reference(cfg, v) for k, v in opt.items()}
    if "vc" in out:
        out["vc"] = _map_shared(cfg, out["vr"], out["vc"],
                                lambda a, L: a[0])
    return out


def opt_from_reference(cfg: ModelConfig, opt: Dict[str, Any],
                       device="cuda") -> Dict[str, Any]:
    """The reference's optimizer state -> the port's (the inverse of
    :func:`opt_to_reference`): a stack's shared column moment copied to
    every layer's leaf."""
    if "vc" in opt:
        opt = dict(opt, vc=_map_shared(
            cfg, opt["vr"], opt["vc"],
            lambda a, L: np.broadcast_to(np.asarray(a),
                                         (L,) + np.shape(a))))
    return {k: from_reference(cfg, v, device) for k, v in opt.items()}


def from_reference(cfg: ModelConfig, tree: Dict[str, Any], device="cuda"
                   ) -> Dict[str, Any]:
    """Reference-layout numpy tree -> the port's per-layer tensor tree on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        out = {k: tree_map(lambda a: _to_tensor(a, dev), v)
               for k, v in tree.items() if k not in ENCDEC_STACKS}
        depths = (cfg.n_enc_layers or cfg.n_layers, cfg.n_layers)
        for name, n in zip(ENCDEC_STACKS, depths):
            out[name] = {str(i): tree_map(
                lambda a, i=i: _to_tensor(np.asarray(a)[i], dev),
                tree[name]) for i in range(n)}
        return out
    out = {k: tree_map(lambda a: _to_tensor(a, dev), v)
           for k, v in tree.items()
           if not k.startswith("group")}
    layers = {}
    for n, (gi, lkey, r) in enumerate(_layer_slots(cfg)):
        sub = tree[f"group{gi}"][lkey]
        pick = (lambda a: a) if r is None else (lambda a, r=r: np.asarray(a)[r])
        layers[str(n)] = tree_map(lambda a, pick=pick: _to_tensor(pick(a),
                                                                  dev), sub)
    out["layers"] = layers
    return out


def to_reference(cfg: ModelConfig, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tensor tree -> reference-layout numpy tree (repeated
    groups and the enc-dec stacks restacked on a leading axis)."""
    if cfg.family == "encdec":
        out = {k: tree_map(_to_numpy, v) for k, v in tree.items()
               if k not in ENCDEC_STACKS}
        for name in ENCDEC_STACKS:
            out[name] = _stack([tree_map(_to_numpy, tree[name][str(i)])
                                for i in range(len(tree[name]))])
        return out
    out = {k: tree_map(_to_numpy, v) for k, v in tree.items()
           if k != "layers"}
    stacks: Dict[tuple, list] = {}
    for n, (gi, lkey, r) in enumerate(_layer_slots(cfg)):
        stacks.setdefault((gi, lkey, r is not None), []).append(
            tree_map(_to_numpy, tree["layers"][str(n)]))
    for (gi, lkey, stacked), subs in stacks.items():
        out.setdefault(f"group{gi}", {})[lkey] = (_stack(subs) if stacked
                                                  else subs[0])
    return out


def tree_from_reference(tree: Dict[str, Any], device="cuda"
                        ) -> Dict[str, Any]:
    """A flat reference tree (nested dicts of numpy arrays, no stacked
    groups, as the paper models keep) -> the same tree of tensors on
    ``device`` (default ``"cuda"``), leaf by leaf."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def tree_to_reference(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's flat tensor tree -> nested dicts of numpy arrays."""
    return tree_map(_to_numpy, tree)
