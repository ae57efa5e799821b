"""Logical-axis -> mesh-axis sharding rules, one table for everything.

Every parameter declares *logical* axis names
(:class:`repro_torch.nn.module.ParamSpec`'s ``axes``); this module maps
them onto mesh axes, as the reference's GSPMD rule table does:

  * TP rules: ``mlp`` / ``heads`` / ``kv_heads`` / ``vocab`` / ``experts``
    prefer the ``model`` axis. Circulant block tables carry the same names
    on their (p, q) dims, so SWM layers shard like dense ones.
  * FSDP: ``embed`` additionally shards over the data axes.
  * ZeRO-1: optimizer moments extend the param spec with the data axes on
    the first still-replicated, divisible dim.
  * A mesh axis is never assigned twice within one tensor, and an
    assignment is dropped whenever the dim is not divisible by the
    mesh-axis size.

The rules read a mesh through its axis names and sizes only: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``), the
abstract production description of :mod:`repro_torch.launch.mesh`, or any
object with ``.axis_names`` and a ``.shape`` mapping. They return the
port's own per-dim spec: a tuple with one entry per dim, each an axis name,
a tuple of names or ``None`` (the entries of the reference's
``PartitionSpec``). :func:`to_placements` turns a spec into DTensor
placements on a real ``DeviceMesh``, and :func:`local_shard` cuts this
rank's slice out of a full tensor.

An *ambient mesh* (set by the launchers and the data-parallel train step)
lets deep call sites pick up the mesh without threading it through every
signature.

The collectives at the end of the module carry autograd: the four region
boundaries of tensor parallelism (:func:`region_input`,
:func:`region_output`, :func:`gather_along`, :func:`gather_replicated`)
and FSDP's one-collective gather of many shards (:func:`gather_many`).
:func:`all_reduce_max` and :func:`all_reduce_sum` carry none (serving's
combine of attention partials over a frame-split cross cache). Each runs over one mesh axis of this rank (an :class:`Axis`) and counts
itself and the bytes of its input buffer in the axis's :class:`CommLog`.
On NCCL (any backend but ``gloo``) they run in the tensor's own dtype:
``all_reduce``, ``all_gather_into_tensor`` and ``reduce_scatter_tensor``.
On a ``gloo`` group they run in f32, a CUDA tensor is staged through host
memory, and a reduce-scatter is an f32 all-reduce of the whole buffer of
which the rank keeps its slice (one collective).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.nn.module import ParamSpec, map_specs

__all__ = [
    "axis_names",
    "axis_size",
    "data_axes",
    "dp_size",
    "batch_pspec",
    "make_param_rules",
    "make_act_rules",
    "spec_to_pspec",
    "param_shardings",
    "opt_shardings",
    "sharded_dim",
    "to_placements",
    "local_slices",
    "local_shard",
    "all_reduce_flat",
    "all_gather_list",
    "COLLECTIVE_KINDS",
    "CommLog",
    "Axis",
    "mesh_axis",
    "region_input",
    "region_output",
    "gather_along",
    "gather_replicated",
    "gather_many",
    "all_reduce_max",
    "all_reduce_sum",
    "gather_to",
    "full_shape",
    "set_ambient_mesh",
    "get_ambient_mesh",
    "constrain_batch_leading",
]

# Data-parallel mesh axes, in nesting order (multi-pod meshes lead with pod).
_DP_NAMES = ("pod", "data")

# Logical axes that prefer the tensor-parallel 'model' axis.
_TP_LOGICAL = ("experts", "mlp", "heads", "kv_heads", "vocab")


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in mesh order."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_size(mesh, axis) -> int:
    """Size of one mesh axis, or the product over a tuple of axes."""
    if isinstance(axis, (tuple, list)):
        return int(np.prod([axis_size(mesh, a) for a in axis]))
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return int(shape[axis])
    return int(shape[axis_names(mesh).index(axis)])


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, in mesh order (e.g. ('pod', 'data'))."""
    return tuple(a for a in axis_names(mesh) if a in _DP_NAMES)


def dp_size(mesh) -> int:
    """Ranks along the data-parallel axes together."""
    return int(np.prod([axis_size(mesh, a) for a in data_axes(mesh)] or [1]))


def _dp_entry(mesh):
    dp = data_axes(mesh)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def batch_pspec(mesh, ndim: int, batch: Optional[int] = None) -> tuple:
    """Spec sharding the leading (batch) dim over the DP axes; ``batch``
    (when known) gates divisibility, so batch=1 cells replicate."""
    lead = _dp_entry(mesh)
    if lead is None or (batch is not None and batch % dp_size(mesh) != 0):
        return (None,) * ndim
    return (lead,) + (None,) * (ndim - 1)


def make_param_rules(mesh, fsdp: bool = False,
                     low_tp: bool = False) -> Dict[str, object]:
    """Logical axis -> preferred mesh axis (or axis tuple) for parameters."""
    rules: Dict[str, object] = {}
    if "model" in axis_names(mesh):
        for name in (_TP_LOGICAL if not low_tp else ("experts",)):
            rules[name] = "model"
    if fsdp and data_axes(mesh):
        rules["embed"] = _dp_entry(mesh)
    return rules


def make_act_rules(mesh) -> Dict[str, object]:
    """Logical axis -> mesh axis for *activations* (batch over DP, TP dims
    matching the param table)."""
    rules: Dict[str, object] = {}
    if data_axes(mesh):
        rules["batch"] = _dp_entry(mesh)
    if "model" in axis_names(mesh):
        for name in ("mlp", "heads", "kv_heads"):
            rules[name] = "model"
    return rules


def spec_to_pspec(axes, shape, rules: Dict[str, object], mesh) -> tuple:
    """Assign mesh axes dim by dim: honor the rule table, never reuse a
    mesh axis within a tensor, drop assignments on non-divisible dims."""
    names = axis_names(mesh)
    used = set()
    entries = []
    for name, dim in zip(axes, shape):
        axis = rules.get(name) if name is not None else None
        if axis is None:
            entries.append(None)
            continue
        flat = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if (any(a in used for a in flat) or any(a not in names for a in flat)
                or dim % axis_size(mesh, axis) != 0):
            entries.append(None)
            continue
        used.update(flat)
        entries.append(tuple(axis) if isinstance(axis, list) else axis)
    return tuple(entries)


def param_shardings(mesh, specs, *, fsdp: bool = False,
                    low_tp: bool = False):
    """ParamSpec tree -> spec tree under the param rule table."""
    rules = make_param_rules(mesh, fsdp, low_tp)
    return map_specs(
        lambda path, s: spec_to_pspec(s.axes, s.shape, rules, mesh), specs)


def opt_shardings(mesh, specs, *, fsdp: bool = False, low_tp: bool = False,
                  zero1: bool = True):
    """Optimizer-moment specs: the param spec, ZeRO-1-extended. ZeRO-1
    shards each moment over the DP axes on the first dim that is still
    replicated and divisible (and > 1 when one is)."""
    rules = make_param_rules(mesh, fsdp, low_tp)
    dp = data_axes(mesh)
    dp_entry = _dp_entry(mesh)
    n = dp_size(mesh)

    def one(path, s: ParamSpec):
        base = list(spec_to_pspec(s.axes, s.shape, rules, mesh))
        base += [None] * (len(s.shape) - len(base))
        if zero1 and dp_entry is not None:
            used = set()
            for e in base:
                used.update(e if isinstance(e, tuple) else (e,))
            if not (set(dp) & used):
                free = [i for i, (e, dim) in enumerate(zip(base, s.shape))
                        if e is None and dim % n == 0]
                big = [i for i in free if s.shape[i] > 1]
                if big or free:
                    base[(big or free)[0]] = dp_entry
        return tuple(base)

    return map_specs(one, specs)


def sharded_dim(spec, axes) -> Optional[int]:
    """The dim of ``spec`` whose entry is ``axes`` (a name or a tuple of
    names), or None."""
    for i, e in enumerate(spec):
        if e == axes:
            return i
    return None


# ---------------------------------------------------------------------------
# Real meshes: DTensor placements and this rank's slice
# ---------------------------------------------------------------------------


def _entry_axes(e) -> tuple:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def to_placements(device_mesh, spec) -> list:
    """A spec -> one DTensor placement per mesh dim: ``Shard(d)`` where
    the mesh axis shards tensor dim d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(device_mesh):
        dims = [d for d, e in enumerate(spec) if name in _entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_slices(shape, spec, device_mesh, coordinate=None) -> tuple:
    """(start, stop) per dim of this rank's block of a ``shape`` tensor
    under ``spec``: a dim sharded over axes (a0, a1, ...) takes the block
    at the rank's row-major coordinate over them. ``coordinate`` (one
    index per mesh axis) defaults to the rank's own
    (``device_mesh.get_coordinate()``)."""
    names = axis_names(device_mesh)
    if coordinate is None:
        coordinate = device_mesh.get_coordinate()
    out = []
    for d, dim in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        if not axes:
            out.append((0, dim))
            continue
        idx = 0
        for a in axes:
            idx = idx * axis_size(device_mesh, a) + int(
                coordinate[names.index(a)])
        size = dim // axis_size(device_mesh, axes)
        out.append((idx * size, (idx + 1) * size))
    return tuple(out)


def local_shard(t: torch.Tensor, spec, device_mesh,
                coordinate=None) -> torch.Tensor:
    """This rank's slice of the full tensor ``t`` under ``spec``
    (:func:`local_slices`). A replicated spec returns ``t`` itself; a
    sharded one, a copy."""
    sl = local_slices(t.shape, spec, device_mesh, coordinate)
    if all(a == 0 and b == dim for (a, b), dim in zip(sl, t.shape)):
        return t
    return t[tuple(slice(a, b) for a, b in sl)].clone()


# ---------------------------------------------------------------------------
# Collectives (gloo's CUDA support does not cover every collective: on a
# gloo group a CUDA tensor goes through host memory)
# ---------------------------------------------------------------------------


def _host_staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_flat(tensors, group=None, divisor: int = 1) -> list:
    """Sum a list of tensors over ``group`` (divided by ``divisor``) as ONE
    flattened f32 buffer, one collective; new tensors in each input's
    shape and dtype (a bf16 leaf round-trips f32 exactly, and a one-rank
    sum over 1 is the input bit for bit)."""
    import torch.distributed as dist

    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    buf = flat.cpu() if _host_staged(flat, group) else flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    flat = buf.to(flat.device) / divisor
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


def all_gather_list(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` over ``group``, in group-rank order."""
    import torch.distributed as dist

    buf = t.detach().contiguous()
    staged = _host_staged(buf, group)
    if staged:
        buf = buf.cpu()
    parts = [torch.empty_like(buf)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return [p.to(t.device) for p in parts] if staged else parts


def full_shape(shape, spec, mesh) -> tuple:
    """The whole tensor's shape from a shard's ``shape`` under ``spec``."""
    return tuple(int(n) * (axis_size(mesh, e) if e is not None else 1)
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


# ---------------------------------------------------------------------------
# One mesh axis of this rank, and the collectives with autograd over it
# ---------------------------------------------------------------------------


#: the kinds of collective a :class:`CommLog` counts, the reference's
#: dry-run's names (the port issues no all-to-all or collective-permute)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


class CommLog:
    """The collectives issued through one or more :class:`Axis` and the
    bytes each carried (the payload of one rank): ``collectives`` and
    ``bytes`` in all, ``counts`` and ``kind_bytes`` by kind (one of
    :data:`COLLECTIVE_KINDS`: what the rank's backend ran, so a ``gloo``
    reduce-scatter, an all-reduce of the whole buffer, counts as an
    all-reduce)."""

    def __init__(self):
        self.collectives = 0
        self.bytes = 0
        self.counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.kind_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def add(self, nbytes: int, n: int = 1, *, kind: str) -> None:
        self.collectives += n
        self.bytes += int(nbytes)
        self.counts[kind] += n
        self.kind_bytes[kind] += int(nbytes)


class Axis:
    """This rank on one mesh axis (or a tuple of axes taken together):
    its process ``group``, the axis ``size`` and this rank's ``index``
    along it (its rank in ``group``). ``log`` counts the collectives.
    ``native``: the group's backend runs them in the tensor's own dtype
    with a true reduce-scatter (every backend but ``gloo``, whose
    collectives go through :func:`_staged_all_reduce` and
    :func:`_staged_all_gather`)."""

    def __init__(self, group, size: int, index: int, log: CommLog,
                 native: bool = False):
        self.group, self.size, self.index = group, int(size), int(index)
        self.log, self.native = log, native

    def __repr__(self):
        return f"Axis(size={self.size}, index={self.index})"


def mesh_axis(device_mesh, axes, log: CommLog) -> Axis:
    """The :class:`Axis` of this rank over mesh axis ``axes`` (a name or a
    tuple of names, flattened row-major as :func:`local_slices` does). A
    tuple of two or more axes of size > 1 takes a group of its own, made
    once per mesh by every rank in the same order (``dist.new_group``)
    and kept on the mesh object, so that it lives as long as the mesh."""
    import torch.distributed as dist

    axes = _entry_axes(axes)
    names = axis_names(device_mesh)
    coord = device_mesh.get_coordinate()
    size, index = 1, 0
    for a in axes:
        size *= axis_size(device_mesh, a)
        index = index * axis_size(device_mesh, a) + int(
            coord[names.index(a)])
    big = [a for a in axes if axis_size(device_mesh, a) > 1]
    if len(big) <= 1:
        group = device_mesh.get_group(big[0] if big else axes[0])
    elif len(big) == len([a for a in names if axis_size(device_mesh, a) > 1]):
        group = dist.group.WORLD
    else:
        groups = device_mesh.__dict__.setdefault("_axis_groups", {})
        if axes not in groups:
            ranks = device_mesh.mesh.permute(
                *[names.index(a) for a in names if a not in axes],
                *[names.index(a) for a in axes])
            ranks = ranks.reshape(-1, size)
            mine = None
            for row in ranks.tolist():
                g = dist.new_group(row)
                if dist.get_rank() in row:
                    mine = g
            groups[axes] = mine
        group = groups[axes]
    return Axis(group, size, index, log,
                native=dist.get_backend(group) != "gloo")


def _staged_all_reduce(t: torch.Tensor, axis: Axis, op=None) -> torch.Tensor:
    """A new f32 tensor: ``t`` reduced over a ``gloo`` axis (sum by
    default), staged through host memory for a CUDA tensor."""
    import torch.distributed as dist

    buf = t.detach().float().contiguous()
    axis.log.add(buf.numel() * buf.element_size(), kind="all-reduce")
    # a new buffer: the host copy, or a clone (``float()`` of an f32
    # tensor is the tensor itself)
    staged = _host_staged(buf, axis.group)
    buf = buf.cpu() if staged else buf.clone()
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=axis.group)
    return buf.to(t.device) if staged else buf


def _staged_all_gather(t: torch.Tensor, axis: Axis) -> list:
    """Every rank's ``t`` along a ``gloo`` axis, in axis order."""
    axis.log.add(t.numel() * t.element_size(), kind="all-gather")
    return all_gather_list(t, axis.group)


def _all_reduce(t: torch.Tensor, axis: Axis, op=None) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``axis`` (sum by default), in
    ``t``'s dtype on a native axis, in f32 on ``gloo``."""
    import torch.distributed as dist

    if not axis.native:
        return _staged_all_reduce(t, axis, op)
    buf = t.detach().contiguous().clone()
    axis.log.add(buf.numel() * buf.element_size(), kind="all-reduce")
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=axis.group)
    return buf


def _all_gather(t: torch.Tensor, axis: Axis) -> list:
    """Every rank's ``t`` along ``axis``, in axis order (one
    ``all_gather_into_tensor`` on a native axis)."""
    import torch.distributed as dist

    if not axis.native:
        return _staged_all_gather(t, axis)
    buf = t.detach().reshape(-1)
    axis.log.add(buf.numel() * buf.element_size(), kind="all-gather")
    out = buf.new_empty(axis.size * buf.numel())
    dist.all_gather_into_tensor(out, buf, group=axis.group)
    return [c.view(t.shape) for c in out.chunk(axis.size)]


def _reduce_scatter(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``t`` summed over ``axis``: one
    ``reduce_scatter_tensor`` in ``t``'s dtype on a native axis; on
    ``gloo``, one f32 all-reduce of which the rank keeps its chunk."""
    import torch.distributed as dist

    if not axis.native:
        return _own_chunk(_staged_all_reduce(t, axis).to(t.dtype), axis,
                          dim).contiguous()
    buf = t.detach().movedim(dim, 0).contiguous()
    axis.log.add(buf.numel() * buf.element_size(), kind="reduce-scatter")
    out = buf.new_empty((buf.shape[0] // axis.size,) + tuple(buf.shape[1:]))
    dist.reduce_scatter_tensor(out, buf, group=axis.group)
    return out.movedim(0, dim).contiguous()


def _own_chunk(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n)


class _RegionInput(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis).to(g.dtype), None


class _RegionOutput(torch.autograd.Function):
    """All-reduce (sum) forward; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    """All-gather along ``dim`` forward; the gradient summed over the axis
    and this rank's slice kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return torch.cat(_all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` forward; the gradient, the same on every
    rank, cut to this rank's slice."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return torch.cat(_all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.axis, ctx.dim).contiguous(), None, None


def region_input(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Enter a sharded region: ``x`` unchanged, its gradient (each rank's
    partial) summed over ``axis``. A no-op without an axis of size > 1."""
    if axis is None or axis.size == 1:
        return x
    return _RegionInput.apply(x, axis)


def region_output(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Leave a sharded region: the ranks' partial ``x`` summed over
    ``axis``; the gradient passes unchanged."""
    if axis is None or axis.size == 1:
        return x
    return _RegionOutput.apply(x, axis)


def gather_along(x: torch.Tensor, axis: Optional[Axis],
                 dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (axis order); the
    backward reduce-scatters (each rank's gradient is a partial)."""
    if axis is None or axis.size == 1:
        return x
    return _GatherAlong.apply(x, axis, dim % x.dim())


def gather_replicated(x: torch.Tensor, axis: Optional[Axis],
                      dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; the backward keeps this
    rank's slice of a gradient that is whole on every rank."""
    if axis is None or axis.size == 1:
        return x
    return _GatherReplicated.apply(x, axis, dim % x.dim())


def all_reduce_max(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis`` (no gradient)."""
    import torch.distributed as dist

    if axis is None or axis.size == 1:
        return x.detach()
    return _all_reduce(x, axis, dist.ReduceOp.MAX).to(x.dtype)


def all_reduce_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise sum of ``x`` over ``axis`` (no gradient)."""
    if axis is None or axis.size == 1:
        return x.detach()
    return _all_reduce(x, axis).to(x.dtype)


class _GatherMany(torch.autograd.Function):
    """FSDP's gather: every shard made whole along its dim with ONE
    all-gather of a flattened buffer (in the shards' dtype, f32 when they
    differ); the backward, ONE reduce-scatter of the flattened gradients
    (summed over the axis, each rank keeping its shards')."""

    @staticmethod
    def forward(ctx, axis, dims, *shards):
        ctx.axis, ctx.dims = axis, dims
        ctx.meta = [(s.shape, s.dtype) for s in shards]
        dtypes = {s.dtype for s in shards}
        ctx.dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
        flat = torch.cat([s.detach().reshape(-1).to(ctx.dtype)
                          for s in shards])
        parts = _all_gather(flat, axis)
        out, off = [], 0
        for s, d in zip(shards, dims):
            n = s.numel()
            out.append(torch.cat([p[off:off + n].reshape(s.shape)
                                  for p in parts], dim=d).to(s.dtype))
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        axis = ctx.axis
        dev = next((g.device for g in grads if g is not None),
                   torch.device("cpu"))
        pieces = []
        for g, (shape, _), d in zip(grads, ctx.meta, ctx.dims):
            full = list(shape)
            full[d] *= axis.size
            if g is None:
                g = torch.zeros(full, dtype=ctx.dtype, device=dev)
            pieces.append(g.to(dev, ctx.dtype).chunk(axis.size, dim=d))
        # rank r's chunk of the flat buffer: its shards' gradients in order
        flat = torch.cat([p[r].reshape(-1) for r in range(axis.size)
                          for p in pieces])
        mine = _reduce_scatter(flat, axis, 0)
        out, off = [], 0
        for shape, dtype in ctx.meta:
            n = int(np.prod(shape))
            out.append(mine[off:off + n].reshape(shape).to(dtype))
            off += n
        return (None, None, *out)


def gather_many(shards, dims, axis: Optional[Axis]) -> list:
    """Each shard made whole along its dim in ``dims`` over ``axis``, with
    one all-gather forward and one reduce-scatter (a summed gradient)
    backward."""
    if axis is None or axis.size == 1 or not shards:
        return list(shards)
    return list(_GatherMany.apply(axis, tuple(dims), *shards))


def gather_to(t: torch.Tensor, full_shape, spec, device_mesh,
              dst: int = 0) -> Optional[torch.Tensor]:
    """The whole tensor in host memory on rank ``dst`` (None on the
    others) from every rank's shard ``t`` under ``spec``: one gather over
    the world's ranks, so that ``dst``'s device holds one leaf's shards at
    a time. A replicated spec returns ``t`` on every rank."""
    import torch.distributed as dist

    full_shape = tuple(full_shape)
    if tuple(t.shape) == full_shape:
        return t
    buf = t.detach().contiguous()
    if _host_staged(buf, None):
        buf = buf.cpu()
    mine = dist.get_rank() == dst
    parts = ([torch.empty_like(buf) for _ in range(dist.get_world_size())]
             if mine else None)
    dist.gather(buf, parts, dst=dst)
    if not mine:
        return None
    out = torch.empty(full_shape, dtype=t.dtype)
    ranks = device_mesh.mesh
    for r, part in enumerate(parts):
        coord = (ranks == r).nonzero()[0].tolist()
        sl = local_slices(full_shape, spec, device_mesh, coord)
        out[tuple(slice(a, b) for a, b in sl)] = part
    return out


# ---------------------------------------------------------------------------
# Ambient mesh
# ---------------------------------------------------------------------------

# Single-element cell so deep call sites can read the mesh without
# signature plumbing; [None] means "no mesh registered".
_AMBIENT_MESH = [None]


def set_ambient_mesh(mesh) -> None:
    """Register (or clear, with None) the process-wide mesh."""
    _AMBIENT_MESH[0] = mesh


def get_ambient_mesh():
    return _AMBIENT_MESH[0]


def constrain_batch_leading(x: torch.Tensor) -> torch.Tensor:
    """The reference's batch-sharding constraint; a no-op here. In the
    port's eager data parallelism each rank already holds only its batch
    shard, so there is nothing to constrain."""
    return x
