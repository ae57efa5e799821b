"""Tensor parallelism over the ``model`` mesh axis and FSDP over the data
axes, for the decoder LM family.

The reference has no counterpart of this module: it declares each leaf's
sharding through the rule table (``repro.dist.sharding.param_shardings``)
and GSPMD partitions the jitted train step, inserting the collectives.
The port runs eagerly, so this module does GSPMD's work by hand. It reads
each leaf's spec under the same rule table (:mod:`repro_torch.dist.sharding`)
and gives every module the layout of this rank's shard; the modules then
run on their shards and cross the collectives with autograd of
``dist.sharding`` (:func:`~repro_torch.dist.sharding.region_input` and
friends). Which reference rule each part realises:

* ``heads`` / ``kv_heads`` on ``model`` (:func:`attention_layout`): q, k
  and v are column-parallel (a table's ``p`` output blocks split), ``o``
  row-parallel (its ``q`` input blocks split, the partial outputs summed).
  The rule decides by a table's block count, not by heads, so this rank's
  K/V can be whole (``p_kv`` not divisible: ``replicated``), exactly the
  KV heads its query heads read (``local``), or a slice that splits a
  head (``gather``: all-gathered, then the heads it needs are taken).
* ``mlp`` on ``model`` (:func:`shard_model`, SwiGLU and MLP): ``wi``/``wu``
  column-parallel, ``wo`` row-parallel.
* ``experts`` on ``model``: each rank runs its ``E / model`` experts on
  the (replicated) tokens routed to them, and the partial combines are
  summed.
* ``vocab`` on ``model``: the embedding's rows and the chunked loss's
  output table; a masked local lookup and a vocab-parallel log-sum-exp.
* ``embed`` over the data axes when ``cfg.fsdp`` (:class:`FSDPPlan`):
  every leaf so sharded is all-gathered at use, one collective per
  decoder layer (again in a ``remat`` recompute), its gradient
  reduce-scattered.

Leaves that the rules leave whole on a ``model`` axis > 1 but that a
sharded region reads (K/V tables in the ``replicated`` case, qk-norm
scales) enter the region through ``region_input``: each rank's gradient of
them is a partial, summed over the axis. Tensor parallelism covers the
``lm`` family's attention-only decoders; :func:`refusal` names what it
does not cover (the recurrent mixers, the enc-dec family, paligemma's
vision prefix), which keeps whole params and trains data-parallel on a
``(world, 1)`` mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.dist.sharding import (Axis, CommLog, _entry_axes,
                                       axis_names, axis_size, data_axes,
                                       local_slices, mesh_axis)

__all__ = ["refusal", "refuse_unsupported", "AttnLayout", "FSDPPlan",
           "attention_layout", "shard_model", "is_sharded", "norm_owner"]


def _model_size(mesh) -> int:
    if "model" not in axis_names(mesh):
        return 1
    return axis_size(mesh, "model")


def refusal(model) -> Optional[str]:
    """What of ``model`` tensor parallelism does not cover, or None."""
    from repro_torch.models.decoder import HybridDecoderLM

    if not isinstance(model, HybridDecoderLM):
        return "the enc-dec family (models/encdec.py)"
    return model.tensor_parallel_refusal()


def refuse_unsupported(model, mesh) -> None:
    """Raise ``NotImplementedError`` when ``mesh`` has a ``model`` axis > 1
    and ``model`` holds a part that tensor parallelism does not cover."""
    m = _model_size(mesh)
    why = refusal(model) if m > 1 else None
    if why is not None:
        raise NotImplementedError(
            f"{model.cfg.name}: {why} does not run under a 'model' mesh "
            f"axis of {m}; tensor parallelism covers the decoder LM "
            f"family's attention, FFN, MoE, embedding and loss (ROADMAP.md "
            f"Queue 1). Train it data-parallel on a (world, 1) mesh.")


def is_sharded(spec, mesh) -> bool:
    """True when ``spec`` splits a dim over a mesh axis of size > 1."""
    return any(axis_size(mesh, a) > 1 for e in spec for a in _entry_axes(e))


def norm_owner(spec, mesh) -> bool:
    """Whether this rank counts its shard of a leaf with ``spec`` in a
    global sum over the world: the rank at coordinate 0 of every mesh axis
    of size > 1 that the spec leaves replicated, so that each element is
    counted once."""
    used = {a for e in spec for a in _entry_axes(e)}
    coord = mesh.get_coordinate()
    return all(int(c) == 0 for a, c in zip(axis_names(mesh), coord)
               if a not in used and axis_size(mesh, a) > 1)


def _sub(tree, path: str):
    for key in path.split(".") if path else ():
        tree = tree[key]
    return tree


def _features(lin, spec, shape, mesh, which: str) -> Tuple[int, int, bool]:
    """(start, stop, sharded) of this rank's ``which`` ('out' | 'in')
    features of Linear ``lin`` under ``spec`` over ``model``."""
    lead = len(lin.expert_dims)
    k = lin.block_size
    if k > 1:
        d = lead + (0 if which == "out" else 1)
    else:
        d = lead + (1 if which == "out" else 0)
    n = shape[d] * (k if k > 1 else 1)
    if "model" not in _entry_axes(spec[d]) or _model_size(mesh) == 1:
        return 0, n, False
    a, b = local_slices(shape, spec, mesh)[d]
    unit = k if k > 1 else 1
    return a * unit, b * unit, True


@dataclasses.dataclass(frozen=True)
class AttnLayout:
    """One rank's share of a self-attention layer. ``q_range``: its query
    features (and ``o``'s input features); ``heads``: the query heads it
    computes (those the range touches); ``kv_heads``: the KV heads they
    read; ``kv``: how its K/V come ('local', 'gather' or 'replicated');
    ``q_gather``: the query range splits a head, so q is all-gathered."""

    axis: Axis
    q_range: Tuple[int, int]
    heads: Tuple[int, int]
    kv_heads: Tuple[int, int]
    kv: str
    q_gather: bool


def attention_layout(attn, specs, pspecs, mesh, axis) -> Optional[AttnLayout]:
    """The :class:`AttnLayout` of ``attn`` on this rank, or None when its
    q table is whole (the layer then runs replicated on every rank)."""
    cfg = attn.cfg
    m = attn._modules

    def feats(name, which):
        return _features(m[name], pspecs[name]["w"], specs[name]["w"].shape,
                         mesh, which)

    q0, q1, qs = feats("q", "out")
    if not qs:
        if any(feats(n, "out")[2] for n in ("k", "v")) or feats(
                "o", "in")[2]:
            raise NotImplementedError(
                f"{cfg.name}: q whole but k, v or o split over 'model'")
        return None
    o0, o1, os_ = feats("o", "in")
    if not os_ or (o0, o1) != (q0, q1):
        raise NotImplementedError(
            f"{cfg.name}: o's input split {(o0, o1)} does not match q's "
            f"output split {(q0, q1)}")
    hd = cfg.head_dim
    group = cfg.n_heads // cfg.n_kv_heads
    h0, h1 = q0 // hd, -(-q1 // hd)
    g0, g1 = h0 // group, (h1 - 1) // group + 1
    k0, k1, ks = feats("k", "out")
    if feats("v", "out") != (k0, k1, ks):
        raise NotImplementedError(f"{cfg.name}: k and v split differently")
    kv = ("replicated" if not ks
          else "local" if (k0, k1) == (g0 * hd, g1 * hd) else "gather")
    return AttnLayout(axis, (q0, q1), (h0, h1), (g0, g1), kv,
                      (q0, q1) != (h0 * hd, h1 * hd))


class FSDPPlan:
    """The leaves of each FSDP unit (a decoder layer ``layers.<i>``, the
    ``embed`` module, the ``lm_head``) that are sharded over the data
    axes, with the dim each is sharded on. :meth:`gathered` makes a
    unit's leaves whole for the body of a ``with`` (one all-gather, a
    reduce-scatter in the backward) and puts the shards back after."""

    def __init__(self, axis: Axis, units: Dict[str, list]):
        self.axis, self.units = axis, units

    @contextlib.contextmanager
    def gathered(self, unit: str):
        from repro_torch.dist.sharding import gather_many

        entries = self.units.get(unit, [])
        if not entries:
            yield
            return
        shards = [mod._buffers[key] for mod, key, _ in entries]
        fulls = gather_many(shards, [d for _, _, d in entries], self.axis)
        for (mod, key, _), f in zip(entries, fulls):
            mod._buffers[key] = f
        try:
            yield
        finally:
            for (mod, key, _), s in zip(entries, shards):
                mod._buffers[key] = s


def _fsdp_entries(unit, upath, pspecs, mesh, dp) -> list:
    out = []
    for name, mod in unit.named_modules():
        sub = _sub(pspecs, ".".join(p for p in (upath, name) if p))
        leaves = sub.items() if isinstance(sub, dict) else ()
        for key, spec in leaves:
            if isinstance(spec, dict):
                continue
            for d, e in enumerate(spec):
                if (set(_entry_axes(e)) & set(dp)
                        and axis_size(mesh, e) > 1):
                    out.append((mod, key, d))
    return out


def shard_model(model, mesh, pspecs, log: CommLog) -> None:
    """Give every module of ``model`` (a decoder LM that :func:`refusal`
    passes) the layout of this rank's shard under ``pspecs`` (the param
    spec tree of ``dist.sharding.param_shardings``): the attention layers
    their :class:`AttnLayout`, the dense FFNs their ``model`` axis (and
    ``wo`` its row-parallel mode), the MoE layers their expert range, the
    embedding and the loss their vocab range, the model its
    :class:`FSDPPlan`."""
    from repro_torch.nn.attention import Attention
    from repro_torch.nn.ffn import MLP, SwiGLU
    from repro_torch.nn.layers import Embedding
    from repro_torch.nn.moe import MoE

    specs = model.specs()
    tp = _model_size(mesh) > 1
    maxis = mesh_axis(mesh, "model", log) if tp else None
    if tp:
        for name, mod in model.named_modules():
            if isinstance(mod, Attention):
                mod.tp = attention_layout(mod, _sub(specs, name),
                                          _sub(pspecs, name), mesh, maxis)
                if mod.tp is not None:
                    mod.o.parallel, mod.o.tp = "row", maxis
            elif isinstance(mod, (SwiGLU, MLP)) and not mod.wi.expert_dims:
                s, p = _sub(specs, name), _sub(pspecs, name)
                a, b, split = _features(mod.wi, p["wi"]["w"],
                                        s["wi"]["w"].shape, mesh, "out")
                if split:
                    wo = _features(mod.wo, p["wo"]["w"], s["wo"]["w"].shape,
                                   mesh, "in")
                    if wo != (a, b, True):
                        raise NotImplementedError(
                            f"{name}: wo's input split {wo} does not match "
                            f"wi's output split {(a, b)}")
                    mod.tp = maxis
                    mod.wo.parallel, mod.wo.tp = "row", maxis
            elif isinstance(mod, MoE):
                spec = _sub(pspecs, name)["experts"]["wi"]["w"]
                if "model" in _entry_axes(spec[0]):
                    shape = _sub(specs, name)["experts"]["wi"]["w"].shape
                    mod.tp = (maxis,) + local_slices(shape, spec, mesh)[0]
            elif isinstance(mod, Embedding):
                spec = _sub(pspecs, name)["table"]
                if "model" in _entry_axes(spec[0]):
                    shape = _sub(specs, name)["table"].shape
                    mod.tp = (maxis,) + local_slices(shape, spec, mesh)[0]
        if model.cfg.tie_embeddings:
            spec, shape, d = (pspecs["embed"]["table"],
                              specs["embed"]["table"].shape, 0)
        else:
            spec, shape, d = (pspecs["lm_head"]["w"],
                              specs["lm_head"]["w"].shape, 1)
        if "model" in _entry_axes(spec[d]):
            model.vocab_shard = (maxis, local_slices(shape, spec, mesh)[d][0])
    dp = data_axes(mesh)
    units = {}
    for unit in [n for n in ("embed", "lm_head") if n in model._modules] + [
            f"layers.{i}" for i in range(len(model._modules["layers"]))]:
        entries = _fsdp_entries(model.get_submodule(unit), unit, pspecs,
                                mesh, dp)
        if entries:
            units[unit] = entries
    if units:
        entry = dp if len(dp) > 1 else dp[0]
        model.fsdp = FSDPPlan(mesh_axis(mesh, entry, log), units)
