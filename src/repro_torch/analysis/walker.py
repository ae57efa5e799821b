"""Op capture with purity and source provenance: the port's traces.

The reference inspects jaxprs; the port runs eagerly, so its "trace" of a
function is the sequence of ops that reached PyTorch's dispatcher while the
function ran. :func:`capture` runs ``fn`` under a ``TorchDispatchMode``
and records every op: its name (``aten.mm``, ``repro_torch.bc_matmul``),
the shapes and dtypes of its tensor inputs and outputs, whether each input
is *pure*, and the ``file:line`` that called it. Composite ops (``matmul``,
``einsum``, ``linear``) arrive decomposed into the ops that run. A
registered kernel op (``kernels.block_circulant.kernel.OPS``) is one
record: the mode is suspended while an op runs, so its CPU impl's plain
version (a DFT as matmuls) is never recorded, which is the reference's
boundary at ``pallas_call``. The mode reaches autograd's backward, on the
CPU and on the CUDA device thread alike (the dispatch-mode stack is part
of the thread-local state autograd carries), so a train step's capture
holds its backward; a ``torch.utils.checkpoint`` recompute is recorded
where it runs, in the backward. A capture counts each op as often as it
runs: an op in a layer repeated L times is recorded L times, where the
reference's trace of a scanned layer group holds it once.

**Purity** (the counterpart of ``collect_pure_vars``): a tensor is pure
when it derives only from weight data. ``capture(..., pure=...)`` seeds
the tensors a model holds as params and frozen tables (held by weak
references keyed by identity, ``torch.utils.weak.WeakIdRef``, so a
capture keeps no tensor alive); factory
ops and Python scalars are pure; an op's outputs are pure iff all its
tensor inputs are; an in-place or ``out=`` op sets the flag of the tensor
it writes, and an impure write also taints the storage it lands in, so a
view of a param that activation data writes through makes the param
impure as well. A storage is known by its address, so a fresh output (its
storage none of its inputs') clears the taint of the address it lands
on: the storage tainted there was freed. Tensors made outside the capture and not seeded (tokens,
caches) are impure. Approximations only ever demote to impure, as the
reference's.

:func:`source_location` is the first frame outside ``torch`` and outside
this package (walked with ``sys._getframe``: formatting a traceback per
op costs too much on a 28-layer engine); ops that autograd's engine runs
with no Python frame above them have none.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdRef

__all__ = ["OpRecord", "Trace", "capture", "iter_ops", "source_location"]

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_HERE = os.path.dirname(os.path.abspath(__file__)) + os.sep


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op that reached the dispatcher during a capture."""

    name: str                                   # e.g. "aten.mm"
    in_shapes: Tuple[Tuple[int, ...], ...]      # tensor inputs, in order
    in_dtypes: Tuple[torch.dtype, ...]
    in_pure: Tuple[bool, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]     # tensor outputs, in order
    out_dtypes: Tuple[torch.dtype, ...]
    pure: bool                                  # every tensor input pure
    where: Optional[str]                        # "file.py:line" or None


@dataclasses.dataclass
class Trace:
    """A capture: its ops in the order they ran, and ``fn``'s result."""

    ops: List[OpRecord]
    result: Any = None

    def __iter__(self) -> Iterator[OpRecord]:
        return iter(self.ops)


def _where() -> Optional[str]:
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_TORCH_DIR) or fn.startswith(_HERE)):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return None


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):    # storage-less tensors
        return 0


def _flat(vals) -> List[torch.Tensor]:
    """The tensors among op arguments or results (a TensorList one level
    down, as ``cat``'s)."""
    out = []
    for v in vals:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(u for u in v if isinstance(u, torch.Tensor))
    return out


_META = {}


def _meta(func):
    """(name, the (position, name) of each argument the op writes), once
    per op overload."""
    m = _META.get(func)
    if m is None:
        writes = tuple((i, arg.name)
                       for i, arg in enumerate(func._schema.arguments)
                       if arg.alias_info is not None
                       and arg.alias_info.is_write)
        m = _META[func] = (str(func.overloadpacket), writes)
    return m


class _Capture(TorchDispatchMode):
    def __init__(self, pure):
        super().__init__()
        # id -> weak reference of every live pure tensor: a pure tensor is
        # the exception, so an impure one costs one dict miss and no weak
        # reference at all
        self.pure_refs = {}
        self.tainted = set()
        self.ops: List[OpRecord] = []
        for t in pure:
            self.mark(t, True)

    def mark(self, t: torch.Tensor, pure: bool) -> None:
        key = id(t)
        if not pure:
            self.pure_refs.pop(key, None)
            return
        refs = self.pure_refs

        def drop(ref, key=key):
            if refs.get(key) is ref:
                del refs[key]

        refs[key] = WeakIdRef(t, drop)

    def is_pure(self, t: torch.Tensor) -> bool:
        ref = self.pure_refs.get(id(t))
        if ref is None or ref() is not t:
            return False
        return not self.tainted or _storage(t) not in self.tainted

    def untaint_fresh(self, outs, ins) -> None:
        """An output whose storage is none of its inputs' is a fresh
        allocation: a tainted address it lands on was freed and reused
        (the caching allocator and malloc both reuse), so the taint of the
        storage that lived there no longer applies."""
        for o in outs:
            ptr = _storage(o)
            if ptr in self.tainted and all(_storage(t) != ptr for t in ins):
                self.tainted.discard(ptr)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name, writes = _meta(func)
        ins = _flat(args)
        if kwargs:
            ins += _flat(kwargs.values())
        in_pure = tuple(self.is_pure(t) for t in ins)
        pure = all(in_pure)
        outs = _flat(out if isinstance(out, (list, tuple)) else (out,))
        for o in outs:
            self.mark(o, pure)
        if self.tainted:
            self.untaint_fresh(outs, ins)
        # in-place / out= writes set the flag of the tensor they write
        for i, arg_name in writes:
            val = args[i] if i < len(args) else kwargs.get(arg_name)
            for t in _flat((val,)):
                self.mark(t, pure)
                if not pure:
                    ptr = _storage(t)
                    if ptr:
                        self.tainted.add(ptr)
        self.ops.append(OpRecord(
            name=name, in_shapes=tuple(tuple(t.shape) for t in ins),
            in_dtypes=tuple(t.dtype for t in ins), in_pure=in_pure,
            out_shapes=tuple(tuple(o.shape) for o in outs),
            out_dtypes=tuple(o.dtype for o in outs), pure=pure,
            where=_where()))
        return out


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def capture(fn, *args, pure=(), **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` eagerly and record every op that
    reaches the dispatcher. ``pure`` is a tensor or a tree (dicts, lists,
    tuples) of the tensors that are weight data."""
    mode = _Capture(_tensors(pure))
    with mode:
        result = fn(*args, **kwargs)
    return Trace(mode.ops, result)


def iter_ops(trace: Trace) -> Iterator[OpRecord]:
    """Every recorded op, in the order it ran (the counterpart of
    ``iter_eqns``; a capture is already flat)."""
    return iter(trace.ops)


def source_location(op: OpRecord) -> Optional[str]:
    """``"path/to/file.py:line"`` of the frame that called ``op``, or
    None (an op autograd's engine ran with no Python frame above)."""
    return op.where
