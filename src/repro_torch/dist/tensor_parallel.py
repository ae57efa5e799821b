"""Tensor parallelism over the ``model`` mesh axis and FSDP over the data
axes, for the decoder LM (attention, Mamba and RWKV mixers) and enc-dec
families.

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
  Cross attention splits the same way, its k and v applied to the
  encoder output, which enters the region; a layer whose q table the rule
  leaves whole runs replicated on every rank.
* ``mlp`` on ``model`` (:func:`shard_model`, SwiGLU and MLP): ``wi``/``wu``
  column-parallel, ``wo`` row-parallel.
* ``mlp`` on ``model`` for the Mamba mixer (:func:`mamba_layout`): each
  rank holds one contiguous range of the ``d_inner`` channels in every
  per-channel leaf (``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``,
  ``D``), in ``dt_proj``'s output and in ``x_proj``'s and ``out_proj``'s
  input. ``in_proj`` keeps the rule's contiguous cut of its ``2 d_inner``
  outputs, which at ``model = 2`` gives rank 0 all of ``xi`` and rank 1
  all of ``z``: its output is all-gathered and the rank takes its
  channels of both halves (the reference's global split, where GSPMD
  reshards). ``x_proj`` is row-parallel and its summed output feeds
  per-channel work on every rank, so it is summed forward and its
  gradient summed backward; ``out_proj`` is row-parallel.
* ``heads`` and ``mlp`` on ``model`` for the RWKV mixer
  (:func:`rwkv_layout`): the time mix's r, k, v and g are
  column-parallel and ``u`` split on its heads, so each rank runs the WKV
  scan, group norm and gate of its heads; ``o`` is row-parallel. The
  leaves the rules leave whole (the mixes, the LoRAs, ``w0``, the group
  norm's scale and bias) enter the region with x, and the decay is
  computed for the rank's channels only. The channel mix's ``wk`` is
  column- and ``wv`` row-parallel; ``wr`` stays whole, and only ``wk``'s
  input enters the region (``r``'s gradient is whole on every rank).
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
scales, the RWKV time mix's whole leaves) enter the region through
``region_input``: each rank's gradient of them is a partial, summed over
the axis. Tensor parallelism covers the ``lm`` family's decoders with
attention, Mamba and RWKV mixers and the enc-dec family; :func:`refusal`
names what it does not cover (paligemma's vision prefix, FSDP of the
enc-dec family), which keeps whole params and trains data-parallel on a
``(world, 1)`` mesh.

Serving (:class:`ServeParallel`) takes the caches of
``launch.specs.cache_shardings``: a self ring split on its KV heads, an
enc-dec cross cache on its KV heads or on its frames (``model`` lands on
the frame axis when ``enc_seq`` equals a channel size the rule names, as
seamless's 4096 = ``d_ff``), a Mamba layer's conv window and SSM state
split on their channels, and an RWKV layer's shift states split on their
channels (all-gathered at each step, ``nn.rwkv``) and WKV state on its
heads; every attention layer, a replicated one too, writes and reads only
what its shard holds (``nn.attention``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.dist.sharding import (Axis, CommLog, _entry_axes,
                                       axis_names, axis_size, data_axes,
                                       local_shard, local_slices, mesh_axis)

__all__ = ["refusal", "refuse_unsupported", "AttnLayout", "FSDPPlan",
           "MambaLayout", "RWKVLayout", "attention_layout", "mamba_layout",
           "rwkv_layout", "shard_model", "shard_params", "ServeParallel",
           "is_sharded", "norm_owner"]


def _model_size(mesh) -> int:
    if "model" not in axis_names(mesh):
        return 1
    return axis_size(mesh, "model")


def refusal(model) -> Optional[str]:
    """What of ``model`` tensor parallelism does not cover, or None."""
    return model.tensor_parallel_refusal()


def refuse_unsupported(model, mesh) -> None:
    """Raise ``NotImplementedError`` when ``mesh`` has a ``model`` axis > 1
    and ``model`` holds a part that tensor parallelism does not cover."""
    m = _model_size(mesh)
    why = refusal(model) if m > 1 else None
    if why is not None:
        raise NotImplementedError(
            f"{model.cfg.name}: {why} does not run under a 'model' mesh "
            f"axis of {m}; tensor parallelism covers the attention, Mamba, "
            f"RWKV, FFN, MoE, embedding and loss of the decoder LM and "
            f"enc-dec families (ROADMAP.md Queue 1). Train it "
            f"data-parallel on a (world, 1) mesh.")


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
    ``q_gather``: the query range splits a head, so q is all-gathered;
    ``kv_range``: the K/V features its tables produce (all of them when
    ``replicated``)."""

    axis: Axis
    q_range: Tuple[int, int]
    heads: Tuple[int, int]
    kv_heads: Tuple[int, int]
    kv: str
    q_gather: bool
    kv_range: Tuple[int, int]


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
                      (q0, q1) != (h0 * hd, h1 * hd), (k0, k1))


@dataclasses.dataclass(frozen=True)
class MambaLayout:
    """One rank's share of a Mamba mixer: ``channels``, the range of the
    ``d_inner`` channels it holds."""

    axis: Axis
    channels: Tuple[int, int]


def mamba_layout(mamba, specs, pspecs, mesh, axis) -> Optional[MambaLayout]:
    """The :class:`MambaLayout` of ``mamba`` on this rank, or None when the
    rules leave all of it whole (it then runs replicated). Every part
    must hold the same channel range: ``NotImplementedError`` names the
    one that does not."""
    m, di = mamba._modules, mamba.d_inner

    def lin(name, which):
        return _features(m[name], pspecs[name]["w"], specs[name]["w"].shape,
                         mesh, which)

    def leaf(name, d):
        spec = pspecs[name]
        if "model" not in _entry_axes(spec[d]) or _model_size(mesh) == 1:
            return 0, di, False
        return local_slices(specs[name].shape, spec, mesh)[d] + (True,)

    a, b, split = lin("in_proj", "out")
    parts = {"dt_proj's output": lin("dt_proj", "out"),
             "x_proj's input": lin("x_proj", "in"),
             "out_proj's input": lin("out_proj", "in"),
             "conv_w": leaf("conv_w", 1), "conv_b": leaf("conv_b", 0),
             "dt_bias": leaf("dt_bias", 0), "A_log": leaf("A_log", 0),
             "D": leaf("D", 0),
             # an even cut of the 2 d_inner outputs: half of its range is
             # the rank's range of each half's channels
             "each half of in_proj's output": (a // 2, b // 2, split)}
    if not any(split for *_, split in parts.values()):
        return None
    first = parts["dt_proj's output"]
    for name, part in parts.items():
        if part != first:
            raise NotImplementedError(
                f"{mamba.cfg.name}: {name} holds channels {part[:2]} "
                f"({'split' if part[2] else 'whole'}) over 'model', "
                f"dt_proj's output {first[:2]}")
    return MambaLayout(axis, first[:2])


@dataclasses.dataclass(frozen=True)
class RWKVLayout:
    """One rank's share of an RWKV time mix: ``heads``, the range of the
    WKV heads it holds, and ``channels``, their ``d_model`` channels
    (``heads`` times ``rwkv_head_dim``)."""

    axis: Axis
    heads: Tuple[int, int]
    channels: Tuple[int, int]


def rwkv_layout(mix, specs, pspecs, mesh, axis) -> Optional[RWKVLayout]:
    """The :class:`RWKVLayout` of the time mix ``mix`` on this rank, or
    None when the rules leave r, k, v, g, o and u whole (it then runs
    replicated). The rule splits a table by its blocks, not by heads:
    ``NotImplementedError`` names a part whose range cuts a head or
    differs from r's output."""
    m, hd, d = mix._modules, mix.cfg.rwkv_head_dim, mix.cfg.d_model

    def lin(name, which):
        return _features(m[name], pspecs[name]["w"], specs[name]["w"].shape,
                         mesh, which)

    spec = pspecs["u"]
    if "model" in _entry_axes(spec[0]) and _model_size(mesh) > 1:
        h0, h1 = local_slices(specs["u"].shape, spec, mesh)[0]
        u = (h0 * hd, h1 * hd, True)
    else:
        u = (0, d, False)
    parts = {f"{n}'s output": lin(n, "out") for n in ("r", "k", "v", "g")}
    parts.update({"o's input": lin("o", "in"), "u's heads": u})
    if not any(split for *_, split in parts.values()):
        return None
    first = parts["r's output"]
    for name, part in parts.items():
        if part[0] % hd or part[1] % hd:
            raise NotImplementedError(
                f"{mix.cfg.name}: {name} holds channels {part[:2]} over "
                f"'model', which cuts a head of {hd} channels")
        if part != first:
            raise NotImplementedError(
                f"{mix.cfg.name}: {name} holds channels {part[:2]} "
                f"({'split' if part[2] else 'whole'}) over 'model', r's "
                f"output {first[:2]}")
    c0, c1 = first[:2]
    return RWKVLayout(axis, (c0 // hd, c1 // hd), (c0, c1))


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
    from repro_torch.nn.module import ParamDict

    out = []
    for name, mod in unit.named_modules():
        if isinstance(mod, ParamDict):     # a frozen tree's fused copy
            continue
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
    their :class:`AttnLayout`, the Mamba mixers their
    :class:`MambaLayout` (and ``x_proj``/``out_proj`` their row-parallel
    mode), the RWKV time mixes their :class:`RWKVLayout` (and ``o`` its
    row-parallel mode), the dense FFNs and RWKV channel mixes their
    ``model`` axis (and ``wo``/``wv`` its row-parallel mode), the MoE
    layers their expert range, the embedding and the loss their vocab
    range, the model its :class:`FSDPPlan`."""
    from repro_torch.nn.attention import Attention
    from repro_torch.nn.ffn import MLP, SwiGLU
    from repro_torch.nn.layers import Embedding
    from repro_torch.nn.moe import MoE
    from repro_torch.nn.rwkv import RWKV6ChannelMix, RWKV6TimeMix
    from repro_torch.nn.ssm import Mamba

    from torch import nn

    specs = model.specs()
    tp = _model_size(mesh) > 1
    maxis = mesh_axis(mesh, "model", log) if tp else None
    if tp:
        for name, mod in model.named_modules():
            if isinstance(mod, Attention):
                mod.cache_axis = maxis
                mod.tp = attention_layout(mod, _sub(specs, name),
                                          _sub(pspecs, name), mesh, maxis)
                if mod.tp is not None:
                    mod.o.parallel, mod.o.tp = "row", maxis
            elif isinstance(mod, Mamba):
                mod.tp = mamba_layout(mod, _sub(specs, name),
                                      _sub(pspecs, name), mesh, maxis)
                if mod.tp is not None:
                    for part in ("x_proj", "out_proj"):
                        lin = mod._modules[part]
                        lin.parallel, lin.tp = "row", maxis
            elif isinstance(mod, RWKV6TimeMix):
                mod.cache_axis = maxis
                mod.tp = rwkv_layout(mod, _sub(specs, name),
                                     _sub(pspecs, name), mesh, maxis)
                if mod.tp is not None:
                    mod.o.parallel, mod.o.tp = "row", maxis
            elif (isinstance(mod, (SwiGLU, MLP)) and not mod.wi.expert_dims
                  or isinstance(mod, RWKV6ChannelMix)):
                # the RWKV channel mix: wk column-, wv row-parallel, wr
                # whole
                wi, wo = ("wi", "wo")
                if isinstance(mod, RWKV6ChannelMix):
                    wi, wo = ("wk", "wv")
                    mod.cache_axis = maxis
                s, p = _sub(specs, name), _sub(pspecs, name)
                a, b, split = _features(mod._modules[wi], p[wi]["w"],
                                        s[wi]["w"].shape, mesh, "out")
                if split:
                    out = mod._modules[wo]
                    got = _features(out, p[wo]["w"], s[wo]["w"].shape, mesh,
                                    "in")
                    if got != (a, b, True):
                        raise NotImplementedError(
                            f"{name}: {wo}'s input split {got} does not "
                            f"match {wi}'s output split {(a, b)}")
                    mod.tp = maxis
                    out.parallel, out.tp = "row", maxis
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
        if "lm_head" not in model._modules:      # the tied embedding
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
            f"{n}.{i}" for n, stack in model._modules.items()
            if isinstance(stack, nn.ModuleList) for i in range(len(stack))]:
        entries = _fsdp_entries(model.get_submodule(unit), unit, pspecs,
                                mesh, dp)
        if entries:
            units[unit] = entries
    if units:
        entry = dp if len(dp) > 1 else dp[0]
        model.fsdp = FSDPPlan(mesh_axis(mesh, entry, log), units)


def _leaf_spec(key: str, pspecs: dict):
    """The spec of leaf ``key`` of a module's param dict: a frozen table
    (``wr``/``wi``, last dim K) takes its ``w``'s, the int8 ``w_scale``
    (one per (p, q) block) the same without the last dim."""
    if key in ("wr", "wi"):
        return pspecs["w"]
    if key == "w_scale":
        return tuple(pspecs["w"])[:-1]
    return pspecs[key]


def _full_shape(key: str, leaf, specs: dict) -> tuple:
    """The whole shape of leaf ``key`` under the model's ``specs``."""
    shape = tuple((specs["w"] if key in ("wr", "wi", "w_scale")
                   else specs[key]).shape)
    if key in ("wr", "wi"):
        return shape[:-1] + (leaf.shape[-1],)
    if key == "w_scale":
        return shape[:-1]
    return shape


def shard_params(tree, specs, pspecs, mesh, coordinate=None):
    """This rank's shard of the param tree ``tree`` (time-domain, or
    frozen by ``plan.freeze_params``, f32 or int8) under ``pspecs`` (the
    spec tree of ``dist.sharding.param_shardings`` over the model's
    ``specs``): a frozen table's ``wr``/``wi`` and ``w_scale`` are cut by
    the block rule of the time-domain ``w`` they came from. The rfft of a
    table runs along k inside each (p, q) block and an int8 scale is per
    block, so freezing and cutting commute bit for bit. A leaf already of
    this rank's shard shape is kept; the fused copies (``FUSED_KEY``) are
    rebuilt from the cut members (``plan.attach_fused``). ``coordinate``
    (one index per mesh axis) cuts another rank's shard, as
    ``dist.sharding.local_slices`` does."""
    from repro_torch.kernels.block_circulant.plan import FUSED_KEY, \
        attach_fused

    def walk(t, sp, ps, path):
        out = {}
        for key, val in t.items():
            if key == FUSED_KEY:
                continue
            if isinstance(val, dict):
                out[key] = walk(val, sp[key], ps[key], path + (key,))
                continue
            spec = _leaf_spec(key, ps)
            full = _full_shape(key, val, sp)
            mine = tuple(b - a for a, b in local_slices(full, spec, mesh,
                                                        coordinate))
            if tuple(val.shape) == full:
                out[key] = local_shard(val, spec, mesh, coordinate)
            elif tuple(val.shape) == mine:
                out[key] = val
            else:
                raise ValueError(
                    f"param {'.'.join(path + (key,))} of shape "
                    f"{tuple(val.shape)} is neither whole {full} nor this "
                    f"rank's shard {mine}")
        return out

    return attach_fused(walk(tree, specs, pspecs, ()))


# (leaf, dim) of the recurrent states that a sharded serve step takes
# split over 'model': Mamba's channels, RWKV's channels and WKV heads
_MODEL_CACHE_DIMS = (("conv", 2), ("ssm", 1), ("shift_att", 1),
                     ("shift_ffn", 1), ("wkv", 1))


class ServeParallel:
    """The parallel half of the serve steps (``serve.engine``'s
    ``make_prefill_step(mesh=)`` / ``make_decode_step(mesh=)``) on
    ``mesh`` for ``model``: the reference's prefill and decode under
    ``param_shardings(..., fsdp=False)`` and ``launch.specs
    .cache_shardings``.

    At construction the model's modules take this rank's layout
    (:func:`shard_model`; a model :func:`refusal` names keeps whole params
    and is refused on a ``model`` axis > 1) and the tensors installed in
    the model, whole or this rank's already, become this rank's shards
    (:func:`shard_params`). A step takes the global tokens (and ``pos``,
    frontend input) on every rank and this rank's cache shard
    (:meth:`init_cache` makes one); it runs this rank's rows, which are
    the rows of its data shard when the cache's slot axis is split over
    the data axes and every row otherwise (a cache whose rule put the data
    axes elsewhere, as on the reference's layer stack). A MoE layer then
    routes over the global batch, as in training. ``log`` counts every
    collective by kind."""

    def __init__(self, mesh, model, cfg):
        import torch.distributed as dist

        from repro_torch.dist.sharding import (data_axes, dp_size,
                                               param_shardings)
        from repro_torch.nn.attention import Attention
        from repro_torch.nn.module import load_tree, map_specs, module_tree

        refuse_unsupported(model, mesh)
        if not hasattr(mesh, "get_coordinate"):
            raise TypeError("a sharded serve step needs a DeviceMesh; an "
                            "abstract mesh description holds no devices")
        self.mesh, self.model, self.cfg = mesh, model, cfg
        self.log = CommLog()
        self.specs = model.specs()
        if refusal(model) is None:
            self.param_specs = param_shardings(mesh, self.specs, fsdp=False)
            shard_model(model, mesh, self.param_specs, self.log)
        else:
            self.param_specs = map_specs(
                lambda path, s: (None,) * len(s.shape), self.specs)
        load_tree(model, shard_params(module_tree(model), self.specs,
                                      self.param_specs, mesh))
        self._cross = [m for m in model.modules()
                       if isinstance(m, Attention) and m.cross]
        self._frames = {}
        dp = data_axes(mesh)
        self.world = dp_size(mesh)
        self.group, self.rank = None, 0
        if self.world > 1:
            self.group = mesh_axis(mesh, dp if len(dp) > 1 else dp[0],
                                   self.log).group
            self.rank = dist.get_rank(self.group)

    @classmethod
    def of(cls, model, cfg, mesh) -> "ServeParallel":
        """The model's ServeParallel on ``mesh``, made once: the prefill
        and decode steps of one model share it (and its ``log``)."""
        par = model.__dict__.get("_serve_parallel")
        if par is None or par.mesh is not mesh:
            par = cls(mesh, model, cfg)
            model.__dict__["_serve_parallel"] = par
        return par

    def cache_shardings(self, batch: int, cache_len: int):
        """The spec tree of the global cache ``(batch, cache_len)``
        (``launch.specs.cache_shardings``), checked: ``model`` only on a
        KV-head dim, a cross cache's frame axis, a Mamba state's channel
        dim (``conv``'s dim 2, ``ssm``'s dim 1) or an RWKV state's
        channel or head dim (``shift_att``'s and ``shift_ffn``'s dim 1,
        ``wkv``'s dim 1), the data axes on every leaf's slot axis or on
        none."""
        from repro_torch.launch.specs import cache_sds, cache_shardings

        sds = cache_sds(self.cfg, batch, cache_len)
        specs = cache_shardings(self.cfg, sds, self.mesh)
        leaves, spec_leaves = _cache_leaves(sds), _cache_leaves(specs)
        rows = set()
        for (path, (shape, _)), (_, spec) in zip(leaves, spec_leaves):
            for d, e in enumerate(spec):
                if ("model" in _entry_axes(e) and _model_size(self.mesh) > 1
                        and not (path[-1] in ("k", "v") and d == 2)
                        and not (path[0] == "cross" and d == 1)
                        and (path[-1], d) not in _MODEL_CACHE_DIMS):
                    raise NotImplementedError(
                        f"{self.cfg.name}: the cache rule puts 'model' on dim "
                        f"{d} of {path} {shape}; a sharded serve step splits "
                        f"a cache over 'model' on its KV heads, a cross "
                        f"cache on its frames, a Mamba state on its "
                        f"channels or an RWKV state on its channels or "
                        f"heads, only")
            rows.add(spec[0] is not None)
        if len(rows) > 1:
            raise NotImplementedError(
                f"{self.cfg.name}: the cache rule splits the slot axis of "
                f"some leaves over the data axes and not others")
        if isinstance(specs, dict):
            self._frames[(batch, cache_len)] = "model" in _entry_axes(
                specs["cross"][0]["k"][1])
        return specs

    def init_cache(self, batch: int, cache_len: int):
        """This rank's shard of ``model.init_cache(batch, cache_len)``
        under :meth:`cache_shardings`, on the model's device."""
        from repro_torch.launch.specs import _map_cache

        specs = self.cache_shardings(batch, cache_len)
        rows = self.rows(batch, split=_cache_leaves(specs)[0][1][0]
                         is not None)
        cache = self.model.init_cache(rows[1] - rows[0], cache_len)
        leaves = iter(_cache_leaves(specs))

        def cut(path, t):
            spec = (None,) + tuple(next(leaves)[1])[1:]
            return local_shard(t, spec, self.mesh)

        return _map_cache(cut, cache)

    def rows(self, batch: int, split: bool):
        """(first, end) of this rank's rows of a global batch of
        ``batch``: its data shard when ``split`` and the data axes divide
        ``batch``, else every row."""
        from repro_torch.dist.sharding import batch_pspec

        spec = batch_pspec(self.mesh, 1, batch=batch) if split else (None,)
        return local_slices((batch,), spec, self.mesh)[0]

    def step_rows(self, batch: int, cache):
        """This rank's rows for a step on the global ``batch`` whose cache
        shard is ``cache``: split when the cache's slot axis is."""
        n = _cache_leaves(cache)[0][1].shape[0]
        split = self.rows(batch, True)
        if n == split[1] - split[0] and n != batch:
            return split
        if n != batch:
            raise ValueError(f"cache shard of {n} rows: neither the batch of "
                             f"{batch} nor this rank's {split[1] - split[0]}")
        return (0, batch)

    @contextlib.contextmanager
    def layout(self, batch: int, cache):
        """The cross attentions' ``frames_split`` for the body of a
        ``with``: whether the cache rule splits the cross caches of the
        global ``batch`` over ``model`` on their frames. The rule reads the
        whole cache's shape, ``(batch, the self rings' length)``, which no
        shard's shape alone tells (a shard of half the frames looks like a
        whole cache of fewer)."""
        split = False
        if self._cross and _model_size(self.mesh) > 1:
            key = (batch, cache["self"][0]["k"].shape[1])
            if key not in self._frames:       # read once per cache shape
                self.cache_shardings(*key)
            split = self._frames[key]
        for mod in self._cross:
            mod.frames_split = split
        try:
            yield
        finally:
            for mod in self._cross:
                mod.frames_split = False

    @contextlib.contextmanager
    def routing(self, rows, batch: int):
        """A MoE layer's routing over the global batch when ``rows`` are a
        part of it (``nn.moe.global_routing``); its all-gathers of the
        per-expert counts join ``log``."""
        from repro_torch.nn.moe import GlobalRouting, global_routing

        route = None
        if self.group is not None and rows[1] - rows[0] < batch:
            route = GlobalRouting(self.group, self.world, self.rank)
        with global_routing(route):
            try:
                yield
            finally:
                if route is not None and route.collectives:
                    self.log.add(route.bytes, route.collectives,
                                 kind="all-gather")


def _cache_leaves(tree, path=()) -> list:
    """(path, leaf) of a cache tree (lists of dicts, or an enc-dec's dict
    of them), in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _cache_leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _cache_leaves(v, path + (i,))]
    return [(path, tree)]
