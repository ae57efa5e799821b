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
    "gather_full",
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


def gather_full(t: torch.Tensor, full_shape, spec,
                device_mesh) -> torch.Tensor:
    """The whole tensor from every rank's shard ``t`` under ``spec`` (a
    collective over the world's ranks; a replicated spec returns ``t``)."""
    full_shape = tuple(full_shape)
    if tuple(t.shape) == full_shape:
        return t
    out = torch.empty(full_shape, dtype=t.dtype, device=t.device)
    ranks = device_mesh.mesh
    for r, part in enumerate(all_gather_list(t)):
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
