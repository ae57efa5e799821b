"""Dry-run of every (arch × shape × mesh) cell on the production mesh, on
the ``meta`` device: no card, no memory, the port's real step.

The reference lowers and compiles each cell with 512 placeholder host
devices and reads the compiled artifact. The port has no compiler, so a
cell here is one run of its step on ``meta`` tensors, as rank 0 of a fake
world of 256 (``single``: mesh (data=16, model=16)) or 512 (``multi``:
(pod=2, data=16, model=16)) ranks: a ``torch.distributed`` group of the
``fake`` backend, whose collectives return at once, under which
``init_device_mesh`` builds the production mesh. The model, its params
(cut to rank 0's shards by the tensor-parallel rules), the caches and the
batch are ``meta`` tensors; both kernels run through their registered fake
impls. The step is the one a user runs: ``train.loop.make_train_step``
(``TrainConfig(microbatch=8)``, backward and optimizer update included)
for a ``train_*`` shape, ``serve.engine.make_prefill_step`` or
``make_decode_step`` (params sharded with ``fsdp=False``, caches under
``launch.specs.cache_shardings``) for the others. A cell whose model the
tensor-parallel rules do not cover (paligemma's vision prefix under
``model`` = 16) is written like the reference's failed cell, with
``error`` and ``traceback``.

The record keeps the reference's keys where the port measures the same
thing, all for rank 0:

* ``params``, ``analytic``, ``tokens``, ``devices``, ``kind``, ``impl``:
  the reference's, from ``launch.specs.count_params`` and
  ``launch.analytic.cell_model``;
* ``argument_size_in_bytes`` / ``output_size_in_bytes`` /
  ``alias_size_in_bytes``: this rank's bytes of the step's inputs, its
  outputs and its donated cache (serve) or state (train), from the specs
  through ``dist.sharding.local_slices``;
* ``temp_size_in_bytes``: the peak of the bytes of live storages the step
  made (its intermediates: activations, saved tensors, grads);
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count, with
  ``launch.roofline.bc_flops`` registered for the ``repro_torch`` kernel
  ops (the FFT ops of the ``paper``/``freq`` impls have no formula there
  and count 0);
* ``collective_counts`` / ``collective_bytes_weighted``: every collective
  the eager step issued and the bytes of its input buffer, by kind, from
  the step's ``CommLog`` (what the reference's trip-weighted figure
  estimates from the HLO);
* ``lower_s``: the meta step's wall seconds.

The reference's once-per-op ``collective_bytes``, ``bytes_accessed``,
``transcendentals``, ``hlo_lines``, ``compile_s`` and
``generated_code_size_in_bytes`` count what XLA compiled and have no
counterpart here.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all            # every cell, both meshes
  python -m repro_torch.launch.dryrun --all --mesh single

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<impl>].json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import (ARCHS, LONG_CONTEXT_ARCHS,
                                          get_config)
from repro_torch.dist.sharding import COLLECTIVE_KINDS, local_slices
from repro_torch.launch.analytic import cell_model
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import count_params, input_specs
from repro_torch.nn.module import map_specs

__all__ = ["fake_world", "measure", "run_cell", "cells", "main", "OUT_DIR"]

OUT_DIR = "experiments/dryrun_torch"


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a ``fake`` process group of ``size``
    ranks (collectives return at once, touching no data), torn down on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the "
                           "dry-run makes its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(spec):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(spec.shape[a]
                                         for a in spec.axis_names),
                            mesh_dim_names=spec.axis_names)


def _meta_key(x):
    """A hashable key of an op argument's metadata (a tensor's shape,
    strides, dtype and device type); ``TypeError`` for what has none."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(map(_meta_key, x))
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in sorted(x.items()))
    if x is None or isinstance(x, (int, float, bool, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return x
    raise TypeError(type(x).__name__)


def _metas(ts) -> list:
    return [(t.shape, t.stride(), t.dtype) for t in ts]


def _fresh(metas) -> list:
    return [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
            for shape, stride, dtype in metas]


class _MetaStep(TorchDispatchMode):
    """The measurements of one ``meta`` step, in one dispatch mode.

    * ``flops``: every op's count under ``FlopCounterMode``'s formulas
      (``torch.utils.flop_counter.flop_registry``, keyed by the op's
      overload packet), the kernel ops' from ``launch.roofline.bc_flops``;
    * ``live`` / ``peak``: the bytes of the storages that ops made and
      that are still alive, and their peak: a storage counts from the op
      that made it until it is freed (a weak reference to its Python
      object, which lives as long as the storage does). The step's inputs
      were made before and never count.

    An op that neither mutates nor aliases its inputs is run once per
    metadata of its arguments: a repeat (the next layer, the next chunk of
    a loop) takes fresh ``meta`` outputs of the recorded shapes, strides
    and dtypes and the recorded flops, as running it again would give on
    ``meta``, where no output depends on a value."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.formulas = {**flop_registry, **_kernel_flops()}
        self.ops: Dict[object, tuple] = {}
        self.cache: Dict[tuple, tuple] = {}
        self.held: Dict[int, tuple] = {}
        self.flops = 0
        self.live = self.peak = 0

    def _drop(self, key):
        ref, nbytes = self.held.pop(key)
        self.live -= nbytes

    def _hold(self, t) -> None:
        """Count the storage of ``t``, an op's fresh output."""
        self.hold_storage(t.untyped_storage())

    def hold_storage(self, st) -> None:
        """Count storage ``st`` until it is freed."""
        key = st._cdata
        if key in self.held:
            return
        nbytes = st.nbytes()
        self.held[key] = (weakref.ref(st, lambda _, key=key: self._drop(
            key)), nbytes)
        self.live += nbytes
        if self.live > self.peak:
            self.peak = self.live

    def release(self, t) -> None:
        """Stop counting the storage of ``t`` before it is freed (a
        replayed backward frees what the real one freed as it ran)."""
        key = t.untyped_storage()._cdata
        if key in self.held:
            ref, nbytes = self.held[key]
            self.held[key] = (ref, 0)
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self.ops.get(func)
        if info is None:
            schema = func._schema
            fresh = not schema.is_mutable and all(
                r.alias_info is None for r in schema.returns)
            info = self.ops[func] = (
                fresh, self.formulas.get(func._overloadpacket))
        fresh, formula = info
        if not fresh:
            # views and in-place ops: no new storage
            out = func(*args, **kwargs)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            return out
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
        except TypeError:
            key = None
        hit = None if key is None else self.cache.get(key)
        if hit is not None:
            spec, metas, flops = hit
            leaves = _fresh(metas)
            out = leaves[0] if spec is None else tree_unflatten(leaves, spec)
        else:
            out = func(*args, **kwargs)
            flops = (0 if formula is None
                     else int(formula(*args, **kwargs, out_val=out)))
            if isinstance(out, torch.Tensor):
                leaves, spec = [out], None
            else:
                leaves, spec = tree_flatten(out)
            if key is not None and leaves and all(
                    isinstance(t, torch.Tensor) and t.device.type == "meta"
                    for t in leaves):
                self.cache[key] = (spec, _metas(leaves), flops)
        self.flops += flops
        for t in leaves:
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out


class _Replayed(torch.autograd.Function):
    """A recorded ``flash_attention`` call (``_replayed_attention``): its
    forward adds the recorded flops and peak rise and holds the bytes the
    real call saved for its backward (as a saved tensor, so that a
    ``remat`` region drops them as it drops the real ones); its backward
    adds the backward's flops and peak rise and returns fresh ``meta``
    grads."""

    @staticmethod
    def forward(ctx, rec, mode, *tensors):
        mode.flops += rec["flops"]
        mode.peak = max(mode.peak, mode.live + rec["rise"])
        ctx.save_for_backward(torch.empty(rec["saved"], dtype=torch.uint8,
                                          device="meta"))
        ctx.rec, ctx.mode = rec, mode
        ctx.metas = _metas(tensors)
        return _fresh([rec["out"]])[0]

    @staticmethod
    def backward(ctx, grad):
        rec, mode = ctx.rec, ctx.mode
        mode.flops += rec["bwd_flops"]
        mode.peak = max(mode.peak, mode.live + rec["bwd_rise"])
        return (None, None) + tuple(_fresh(ctx.metas))


def _record(real, mode: "_MetaStep", args, kwargs) -> dict:
    """One standalone run of ``flash_attention`` on ``args``: the flops
    and the peak rise of its forward and (when q, k or v needs a grad) of
    its backward, the bytes it leaves saved for the backward, and its
    output's metadata. ``mode``'s totals are left as they were."""
    flops, live, peak = mode.flops, mode.live, mode.peak
    q, k, v = (t.detach().requires_grad_(t.requires_grad) for t in args[:3])
    need = [t for t in (q, k, v) if t.requires_grad]
    rec = {"bwd_flops": 0, "bwd_rise": 0}
    mode.peak = live
    # its own saved-tensor hooks: a ``remat`` region's (checkpoint's) see
    # only the replay's
    with torch.enable_grad() if need else contextlib.nullcontext(), \
            torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                     lambda t: t):
        out = real(q, k, v, *args[3:], **kwargs)
    rec["flops"], rec["rise"] = mode.flops - flops, mode.peak - live
    (rec["out"],) = _metas([out])
    rec["saved"] = max(mode.live - live - out.untyped_storage().nbytes(), 0)
    if need:
        grad = torch.empty_like(out)
        before, mode.peak = mode.flops, mode.live
        start = mode.live
        grads = torch.autograd.grad(out, need, grad)
        rec["bwd_flops"] = mode.flops - before
        rec["bwd_rise"] = mode.peak - start
        del grads, grad
    del out, q, k, v, need
    mode.flops, mode.peak = flops, peak
    return rec


@contextlib.contextmanager
def _replayed_attention(mode: "_MetaStep"):
    """``nn.attention.flash_attention`` run once per metadata of its
    arguments: every call (the first too) is a :class:`_Replayed` of that
    one standalone run (:func:`_record`), so a repeat (the next layer of
    one shape, the next microbatch, a ``remat`` recompute) adds the
    recorded flops and peak rises forward and backward, and holds the
    recorded saved bytes between them. The function is pure, so running
    it again on ``meta`` would issue the same ops to the same effect."""
    from repro_torch.nn import attention

    real = attention.flash_attention
    memo: Dict[tuple, dict] = {}

    def flash(*args, **kwargs):
        key = (_meta_key(args), _meta_key(kwargs),
               tuple(t.requires_grad for t in args[:3]),
               torch.is_grad_enabled())
        rec = memo.get(key)
        if rec is None:
            rec = memo[key] = _record(real, mode, args, kwargs)
        return _Replayed.apply(rec, mode, *args[:3])

    attention.flash_attention = flash
    try:
        yield
    finally:
        attention.flash_attention = real


class _LoopCall:
    """One ``nn.scan._loop`` call's signature, holding no tensor (a
    replayed call must not keep its inputs alive): the step function's
    code and the non-tensor values of its closure, and the metadata of
    its tensors, flat: the carry's leaves, the time-major inputs and the
    tensors of the step's closure (a Mamba step reads ``A`` and the mask
    from there). :attr:`tensors` holds the call's own tensors until the
    call has been keyed and recorded."""

    def __init__(self, step_fn, carry, xs):
        self.code, self.globals = step_fn.__code__, step_fn.__globals__
        cells = [c.cell_contents for c in step_fn.__closure__ or ()]
        self.is_tensor = [isinstance(v, torch.Tensor) for v in cells]
        self.consts = tuple(v for v, t in zip(cells, self.is_tensor)
                            if not t)
        carry, self.carry_spec = tree_flatten(carry)
        self.n_carry, self.n_xs = len(carry), len(xs)
        self.tensors = carry + list(xs) + [
            v for v, t in zip(cells, self.is_tensor) if t]
        self.metas = _metas(self.tensors)
        self.grads = tuple(t.requires_grad for t in self.tensors)

    def key(self):
        return (self.code, _meta_key(self.consts), tuple(self.metas),
                self.grads, self.carry_spec, torch.is_grad_enabled())

    def leaves(self) -> list:
        """Fresh ``meta`` leaves of the call's tensors' metadata, each
        requiring a grad where the call's does."""
        return [t.requires_grad_(g) for t, g in zip(_fresh(self.metas),
                                                   self.grads)]

    def run(self, real, tensors):
        """The real loop on ``tensors`` (in :attr:`tensors`'s order):
        its outputs, flat (the carry's leaves, then the stacked ys)."""
        import types

        n = self.n_carry + self.n_xs
        it, consts = iter(tensors[n:]), iter(self.consts)
        cells = [next(it) if t else next(consts) for t in self.is_tensor]
        step_fn = types.FunctionType(self.code, self.globals, None, None,
                                     tuple(types.CellType(v) for v in cells))
        carry = tree_unflatten(list(tensors[:self.n_carry]), self.carry_spec)
        carry, ys = real(step_fn, carry, tuple(tensors[self.n_carry:n]))
        outs, self.out_spec = tree_flatten((carry, ys))
        return outs


def _drops_saved() -> bool:
    """Whether a tensor saved for the backward now is dropped: inside the
    forward of a non-reentrant ``torch.utils.checkpoint`` region (its
    recompute, and a step outside any region, keep theirs)."""
    top = getattr(torch._C._autograd, "_top_saved_tensors_default_hooks",
                  None)
    hooks = None if top is None else top(False)
    return hooks is not None and "_checkpoint_hook" in getattr(
        hooks[0], "__qualname__", "")


def _keep_saved(mode=None, marks=None, stores=None):
    """Saved-tensor hooks that keep what a standalone run saves, as no
    hooks would, shielding it from a ``remat`` region's: the pack hook
    keeps a detached alias (an op's own output, kept with its grad_fn,
    would make a reference cycle through the graph that outlives it).
    With ``marks``, each save appends ``mode``'s flops and peak as they
    were when it was made; with ``stores``, each save adds its storage's
    key to the set."""
    def pack(t):
        if marks is not None:
            marks.append((mode.flops, mode.peak))
        if stores is not None:
            stores.add(t.untyped_storage()._cdata)
        return t.detach()

    return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


def _measure(mode, fn):
    """``fn()``'s flops and peak rise above the live bytes it started at,
    and its result; ``mode``'s totals left as they were."""
    flops, live, peak = mode.flops, mode.live, mode.peak
    mode.peak = live
    out = fn()
    rise, got = mode.peak - live, mode.flops - flops
    mode.flops, mode.peak = flops, peak
    return got, rise, out


def _record_loop(real, mode, call) -> dict:
    """One standalone run of the loop of ``call``: its forward flops and
    peak rise with the saved tensors dropped (inside a ``remat`` region's
    forward), kept (outside one, or in its recompute) or not made (no
    grad), the bytes a kept run leaves saved, and its outputs' metadata."""
    rec = {"bwd": {}}
    peak = mode.peak            # the record's own leaves are not the step's
    leaves = call.leaves()
    if not torch.is_grad_enabled():
        rec["flops"], rec["rise"], out = _measure(
            mode, lambda: call.run(real, leaves))
        rec["out"] = _metas(out)
        mode.peak = peak
        return rec
    with torch.autograd.graph.saved_tensors_hooks(lambda t: t.shape,
                                                  lambda t: None):
        _, rec["rise_drop"], out = _measure(
            mode, lambda: call.run(real, leaves))
    del out
    live, flops, marks, stores = mode.live, mode.flops, [], set()
    with _keep_saved(mode, marks, stores):
        rec["flops"], rec["rise"], out = _measure(
            mode, lambda: call.run(real, leaves))
    # the inputs the loop saves, which the real backward keeps alive after
    # the caller lets them go (a scan's carry from the chunk before)
    rec["saved_inputs"] = [i for i, t in enumerate(leaves)
                           if t.untyped_storage()._cdata in stores]
    # a remat region's recompute stops at the region's last save: the
    # flops and peak rise of the loop up to its last save, for a region
    # that ends with the loop (an input is saved before its op runs)
    rec["flops_stop"], rec["rise_stop"] = (
        (marks[-1][0] - flops, marks[-1][1] - live) if marks
        else (rec["flops"], rec["rise"]))
    rec["out"] = _metas(out)
    rec["saved"] = max(mode.live - live - sum(
        o.untyped_storage().nbytes() for o in out), 0)
    del out
    mode.peak = peak
    return rec


def _record_backward(real, mode, call, given) -> tuple:
    """The flops and peak rise of the loop's backward when the outputs
    ``given`` (a mask over them) receive grads, from a kept standalone
    forward; ``mode``'s totals left as they were."""
    flops, live, peak = mode.flops, mode.live, mode.peak
    leaves = call.leaves()
    need = [t for t in leaves if t.requires_grad]
    with torch.enable_grad(), _keep_saved():
        out = call.run(real, leaves)
    roots = [o for o, g in zip(out, given) if g and o.requires_grad]
    grads = [torch.empty_like(o) for o in roots]
    before, start = mode.flops, mode.live
    mode.peak = start
    got = torch.autograd.grad(roots, need, grads, allow_unused=True)
    result = (mode.flops - before, mode.peak - start)
    del got, grads, roots, out, leaves, need
    mode.flops, mode.peak = flops, peak
    return result


class _ReplayedLoop(torch.autograd.Function):
    """A recorded ``_loop`` call (``_replayed_scan``) under autograd. Its
    forward adds the recorded flops and, by whether the saved bytes it
    saves are kept (a ``remat`` region's forward drops them, its
    recompute keeps them), the peak rise of a dropping or a keeping run;
    its forward also saves the inputs the real loop saves, which outlive
    the caller's references as the real ones do; its backward adds the
    recorded backward's flops and peak rise, stops counting the saved
    bytes (the real backward frees them as it runs) and returns fresh
    ``meta`` grads."""

    @staticmethod
    def forward(ctx, real, mode, call, rec, *tensors):
        from torch.utils._python_dispatch import _disable_current_modes

        live = mode.live
        mode.flops += rec["flops"]
        drop = _drops_saved()
        # the saved bytes, counted while they are kept, and the inputs the
        # real loop saves
        with _disable_current_modes() if drop else contextlib.nullcontext():
            ctx.save_for_backward(torch.empty(rec["saved"],
                                              dtype=torch.uint8,
                                              device="meta"),
                                  *[tensors[i] for i in rec["saved_inputs"]])
        if drop:
            mode.peak = max(mode.peak, live + rec["rise_drop"])
        ctx.set_materialize_grads(False)
        ctx.real, ctx.mode, ctx.call, ctx.rec = real, mode, call, rec
        return tuple(_fresh(rec["out"]))

    @staticmethod
    def backward(ctx, *grads):
        mode, rec = ctx.mode, ctx.rec
        saved = ctx.saved_tensors[0]
        given = tuple(g is not None for g in grads)
        if given not in rec["bwd"]:
            rec["bwd"][given] = _record_backward(ctx.real, mode, ctx.call,
                                                 given)
        flops, rise = rec["bwd"][given]
        mode.flops += flops
        mode.peak = max(mode.peak, mode.live + rise)
        mode.release(saved)
        del saved
        return (None,) * 4 + tuple(
            _fresh([m])[0] if g else None
            for m, g in zip(ctx.call.metas, ctx.call.grads))


@contextlib.contextmanager
def _replayed_scan(mode: "_MetaStep"):
    """``nn.scan._loop`` (the time loop of ``chunked_time_scan``: the
    Mamba and RWKV scans) run once per metadata of its arguments, as
    :func:`_replayed_attention` runs ``flash_attention``: a prefill's
    32,768 steps or a train step's chunks of 256, each a Python loop of
    its step's ops, are then one recorded call per layer and chunk. The
    record (:func:`_record_loop`) is taken by the real loop on ``meta``,
    where no output depends on a value; a call whose arguments have no
    metadata key runs the real loop."""
    from repro_torch.nn import scan

    real = scan._loop
    memo: Dict[tuple, dict] = {}
    stop = getattr(torch.utils.checkpoint, "_StopRecomputationError", ())

    def loop(step_fn, carry, xs):
        call = _LoopCall(step_fn, carry, xs)
        try:
            key = call.key()
        except TypeError:
            return real(step_fn, carry, xs)
        rec = memo.get(key)
        if rec is None:
            rec = memo[key] = _record_loop(real, mode, call)
            rec["out_spec"] = call.out_spec
        tensors, call.tensors = call.tensors, None
        if torch.is_grad_enabled():
            live, peak, drop = mode.live, mode.peak, _drops_saved()
            try:
                out = _ReplayedLoop.apply(real, mode, call, rec, *tensors)
            except stop:
                # the recompute of a region that ends with this loop
                # stopped at the loop's save, as the real one stops at its
                # last save: before its outputs, which the replay's forward
                # made before autograd took its saves
                mode.flops -= rec["flops"] - rec["flops_stop"]
                mode.peak = max(peak, live + rec["rise_stop"])
                raise
            if not drop:
                mode.peak = max(mode.peak, live + rec["rise"])
        else:
            live = mode.live
            mode.flops += rec["flops"]
            mode.peak = max(mode.peak, live + rec["rise"])
            out = _fresh(rec["out"])
        return tree_unflatten(list(out), rec["out_spec"])

    scan._loop = loop
    try:
        yield
    finally:
        scan._loop = real


def _kernel_flops() -> dict:
    """Flop formulas of the ``repro_torch`` kernel ops (by overload
    packet, as ``FlopCounterMode`` keys them), from
    ``launch.roofline.bc_flops``."""
    from repro_torch.launch.roofline import bc_flops

    def groups(x):
        return int(np.prod(x.shape[:-2] or (1,)))

    def matmul(x, wr, wi, bias, w_scale, k, activation, out_val=None):
        return bc_flops(x.shape[-2], wr.shape[-3], wr.shape[-2], k,
                        groups(x))

    def dw(x, g, P, Q, k, out_val=None):
        return bc_flops(x.shape[-2], P, Q, k, groups(x), inverse=P * Q)

    def dw_freq(x, g, P, Q, k, out_val=None):
        return bc_flops(x.shape[-2], P, Q, k, groups(x))

    ops = torch.ops.repro_torch
    return {ops.bc_matmul: matmul, ops.bc_dw: dw, ops.bc_dw_freq: dw_freq}


def _is_sds(t) -> bool:
    return (isinstance(t, tuple) and len(t) == 2
            and isinstance(t[1], torch.dtype))


def _leaves(tree, is_leaf) -> list:
    """The leaves of a tree of dicts (keys sorted) and lists."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    return [x for v in tree for x in _leaves(v, is_leaf)]


def _local_bytes(sds, shardings, mesh) -> int:
    """This rank's bytes of a tree of ``(shape, dtype)`` stand-ins under
    the spec tree ``shardings``."""
    specs = _leaves(shardings, lambda t: isinstance(t, tuple))
    return sum(int(np.prod([b - a for a, b in local_slices(shape, spec,
                                                            mesh)] or [1]))
               * dtype.itemsize
               for (shape, dtype), spec in zip(_leaves(sds, _is_sds), specs))


def _meta(sds):
    """``meta`` tensors of a tree of ``(shape, dtype)`` stand-ins."""
    if _is_sds(sds):
        return torch.empty(sds[0], dtype=sds[1], device="meta")
    return {k: _meta(v) for k, v in sds.items()}


def _run_train(cfg, shape, mesh, tcfg, specs):
    from repro_torch.convert import layer_stacks
    from repro_torch.launch.specs import build_model
    from repro_torch.train.loop import init_train_state, make_train_step

    model = build_model(cfg, device="meta")
    step = make_train_step(model, cfg, tcfg, mesh=mesh)
    shard = step.data_parallel.state_shardings
    whole = map_specs(lambda path, s: torch.empty(
        s.shape, dtype=s.dtype, device="meta"), model.specs())
    state = init_train_state(whole, tcfg, cfg.optimizer,
                             opt_shardings=shard["opt"],
                             param_shardings=shard["params"], mesh=mesh,
                             stacks=layer_stacks(cfg))
    batch = _meta(specs["batch_sds"])
    return (lambda: step(state, batch)), step.data_parallel.log


def _run_serve(cfg, shape, mesh, specs):
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import load_tree
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    model = build_model(cfg, device="meta")
    load_tree(model, map_specs(lambda path, s: torch.empty(
        s.shape, dtype=s.dtype, device="meta"), model.specs()))
    make = make_prefill_step if shape.kind == "prefill" else make_decode_step
    step = make(model, cfg, mesh=mesh)
    B, S = shape.global_batch, shape.seq_len
    cache = step.parallel.init_cache(B, S)
    tokens = torch.zeros((B, S if shape.kind == "prefill" else 1),
                         dtype=torch.int32, device="meta")
    args = [tokens, cache]
    if shape.kind == "prefill" and "extra_sds" in specs:
        args.append(_meta(specs["extra_sds"]))
    elif shape.kind != "prefill":
        args.append(torch.zeros((B,), dtype=torch.int32, device="meta"))
    return (lambda: step(*args)), step.parallel.log


def _io_bytes(cfg, shape, mesh, specs) -> Dict[str, int]:
    """This rank's argument, output and donated bytes (the reference's
    memory-analysis fields) from the specs."""
    from repro_torch.dist.sharding import batch_pspec

    if shape.kind == "train":
        state = _local_bytes(specs["state_sds"], specs["state_shardings"],
                             mesh)
        batch = _local_bytes(specs["batch_sds"], specs["batch_shardings"],
                             mesh)
        return {"argument_size_in_bytes": state + batch,
                "output_size_in_bytes": state, "alias_size_in_bytes": state}
    params = _local_bytes(specs["params_sds"], specs["params_shardings"],
                          mesh)
    cache = _local_bytes(specs["cache_sds"], specs["cache_shardings"], mesh)
    args = params + cache + _local_bytes(
        specs["tokens_sds"], specs["tokens_shardings"], mesh)
    for key in ("extra", "pos"):
        if f"{key}_sds" in specs:
            args += _local_bytes(specs[f"{key}_sds"],
                                 specs[f"{key}_shardings"], mesh)
    B = shape.global_batch
    logits = _local_bytes(((B, cfg.vocab), torch.float32),
                          batch_pspec(mesh, 2, batch=B), mesh)
    return {"argument_size_in_bytes": args,
            "output_size_in_bytes": logits + cache,
            "alias_size_in_bytes": cache}


def measure(cfg, shape, spec) -> dict:
    """One step of ``cfg`` at ``shape`` on ``meta`` as rank 0 of a fake
    world on the abstract mesh ``spec`` (``launch.mesh.MeshSpec``): the
    measured part of a record (module docstring), ``lower_s`` included.
    Raises what the step raises."""
    # production training accumulates over 8 microbatches, as the
    # reference's dry-run does
    tcfg = TrainConfig(microbatch=8)
    with fake_world(spec.size):
        mesh = _device_mesh(spec)
        specs = input_specs(cfg, shape, mesh, tcfg)
        if shape.kind == "train":
            run, log = _run_train(cfg, shape, mesh, tcfg, specs)
        else:
            run, log = _run_serve(cfg, shape, mesh, specs)
        mode = _MetaStep()
        t0 = time.perf_counter()
        with mode, _replayed_attention(mode), _replayed_scan(mode):
            out = run()
        lower_s = time.perf_counter() - t0
        del out
        return {
            "lower_s": round(lower_s, 1),
            **_io_bytes(cfg, shape, mesh, specs),
            "temp_size_in_bytes": int(mode.peak),
            "flops": float(mode.flops),
            "collective_counts": {k: int(log.counts[k])
                                  for k in COLLECTIVE_KINDS},
            "collective_bytes_weighted": {k: int(log.kind_bytes[k])
                                          for k in COLLECTIVE_KINDS},
        }


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             impl: Optional[str] = None,
             seq_override: Optional[int] = None) -> dict:
    """One cell on ``meta`` as rank 0 of the fake production world: the
    record described in the module docstring. Raises what the step
    raises (``main`` writes it as a failed cell)."""
    cfg = get_config(arch)
    if impl:
        cfg = dataclasses.replace(
            cfg, swm=dataclasses.replace(cfg.swm, impl=impl)
            if impl != "dense"
            else dataclasses.replace(cfg.swm, block_size=0))
    shape = SHAPES[shape_name]
    if seq_override:
        shape = dataclasses.replace(shape, seq_len=seq_override)
    spec = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    measured = measure(cfg, shape, spec)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "impl": impl or cfg.swm.impl, "kind": shape.kind,
        "devices": spec.size, "lower_s": measured.pop("lower_s"),
        "params": count_params(cfg),
        "tokens": (shape.global_batch * shape.seq_len
                   if shape.kind != "decode" else shape.global_batch),
        **measured,
        "analytic": cell_model(cfg, shape, chips=spec.size),
    }


def cells(include_long: bool = True):
    """(arch, shape) of every cell: ``long_500k`` only for the archs of
    ``LONG_CONTEXT_ARCHS``."""
    for arch in ARCHS:
        for shape_name in SHAPES:
            if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            if not include_long and shape_name == "long_500k":
                continue
            yield arch, shape_name


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default=None,
                    help="one mesh (default: single; with --all, both)")
    ap.add_argument("--impl", default=None,
                    help="override swm impl: paper|freq|dft|pallas|dense")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        meshes = (args.mesh,) if args.mesh else ("single", "multi")
        todo = [(arch, shape, mesh) for arch, shape in cells()
                for mesh in meshes]
    else:
        todo = [(args.arch, args.shape, args.mesh or "single")]
    tally = {"OK": 0, "FAIL": 0, "skip": 0}
    for arch, shape, mesh in todo:
        tag = f"{arch}__{shape}__{mesh}" + (f"__{args.impl}" if args.impl
                                            else "")
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip] {tag}")
            tally["skip"] += 1
            continue
        print(f"[run ] {tag}", flush=True)
        try:
            res = run_cell(arch, shape, mesh, args.impl, args.seq)
            status = "OK"
        except Exception as e:  # lint: allow-broad-except — record per-cell failures in the artifact
            res = {"arch": arch, "shape": shape, "mesh": mesh,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            status = "FAIL"
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        tally[status] += 1
        print(f"[{status}] {tag} "
              + (f"flops={res.get('flops')} "
                 f"coll={res.get('collective_counts')}" if status == "OK"
                 else res["error"]), flush=True)
    print(f"cells: {tally['OK']} OK, {tally['FAIL']} FAIL, "
          f"{tally['skip']} skipped")
    return tally


if __name__ == "__main__":
    main()
