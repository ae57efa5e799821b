"""Declarative structural rules over captured programs.

Each rule is a small named object with a ``check`` method returning
:class:`Violation`\\ s, never booleans, so every failure carries the rule
name, the offending op and the ``file:line`` that called it. Rules are
grouped into per-surface contracts by :mod:`repro_torch.analysis.contracts`.
They read a :class:`~repro_torch.analysis.walker.Trace` (a capture), where
the reference's read a jaxpr; the ops they look for:

=================  ==========================================================
reference          port
=================  ==========================================================
``fft``            ``aten._fft_r2c``, ``_fft_c2r``, ``_fft_c2c``
``dot_general``    ``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
                   ``dot`` (``matmul``, ``einsum`` and ``linear`` arrive
                   decomposed into these)
``concatenate``    ``aten.cat``
``pallas_call``    the registered kernel ops ``repro_torch.bc_matmul``,
                   ``bc_dw`` and ``bc_dw_freq``
=================  ==========================================================

Trace rules (``check(trace)``): :class:`NoFFT`, :class:`NoWeightFFT` (an
fft of pure, weight-derived data: the capture's purity flags, not shape
matching), :class:`NoDenseDotGeneral`, :class:`DenseFallbackDot` (a
contraction against a circulant layer's dense-equivalent ``(q·k, p·k)``
operand; with ``weight_side`` only a pure operand counts, so activations
that a composite collapsed to ``(B·S, d)`` pass), :class:`LaunchBudget`
and :class:`NoWeightConcat`. Value rule: :class:`QuantizedTableDtypes`
(``check_params``).

The reference's ``DonatedInputsAliased`` has no counterpart: it reads the
input-output aliasing of a lowered XLA module, and the port has none. Its
engine writes the cache in place and donates nothing, so there is nothing
to check.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import torch

from repro_torch.analysis.walker import OpRecord, iter_ops

__all__ = ["Violation", "NoFFT", "NoWeightFFT", "NoDenseDotGeneral",
           "DenseFallbackDot", "LaunchBudget", "NoWeightConcat",
           "QuantizedTableDtypes", "FFT_OPS", "DOT_OPS", "LAUNCH_OPS"]

FFT_OPS = frozenset({"aten._fft_r2c", "aten._fft_c2r", "aten._fft_c2c"})
DOT_OPS = frozenset({"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm",
                     "aten.mv", "aten.dot"})
LAUNCH_OPS = frozenset({"repro_torch.bc_matmul", "repro_torch.bc_dw",
                        "repro_torch.bc_dw_freq"})


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract: which rule, on which surface, where in the
    code."""

    rule: str
    message: str
    surface: str = ""
    primitive: str = ""
    where: Optional[str] = None        # "file.py:line" (or None)

    def __str__(self) -> str:
        loc = f" at {self.where}" if self.where else ""
        prim = f" [{self.primitive}]" if self.primitive else ""
        surf = f"{self.surface}: " if self.surface else ""
        return f"{surf}{self.rule}: {self.message}{prim}{loc}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _flag(rule: str, message: str, op: Optional[OpRecord] = None
          ) -> Violation:
    return Violation(rule=rule, message=message,
                     primitive=op.name if op is not None else "",
                     where=op.where if op is not None else None)


class NoFFT:
    """No fft op anywhere (weights *and* activations frozen out)."""

    name = "NoFFT"

    def check(self, trace) -> List[Violation]:
        return [_flag(self.name,
                      f"fft ({op.name.split('.')[-1]}) over operand shape "
                      f"{op.in_shapes[0]} in a trace that promises frozen "
                      f"frequency tables and no transform work", op)
                for op in iter_ops(trace) if op.name in FFT_OPS]


class NoWeightFFT:
    """No fft consuming pure (parameter-derived) data. Activation
    transforms are tainted by tokens or the cache and pass, whatever their
    shapes."""

    name = "NoWeightFFT"

    def check(self, trace) -> List[Violation]:
        return [_flag(self.name,
                      f"weight-side fft over parameter-derived data "
                      f"{op.in_shapes[0]} -> {op.out_shapes[0]}; frozen "
                      f"plans must carry rfft(w) as data (freeze_params), "
                      f"never re-transform per call", op)
                for op in iter_ops(trace)
                if op.name in FFT_OPS and op.in_pure[0]]


class NoDenseDotGeneral:
    """Zero dense contractions outside the kernel ops (strict)."""

    name = "NoDenseDotGeneral"

    def check(self, trace) -> List[Violation]:
        return [_flag(self.name,
                      f"dense {op.name} over {list(op.in_shapes)} outside "
                      f"any kernel launch — the circulant path must not "
                      f"fall back to dense contractions", op)
                for op in iter_ops(trace) if op.name in DOT_OPS]


class DenseFallbackDot:
    """No contraction whose rank-2 operand has a circulant layer's
    dense-equivalent ``(in, out) = (q·k, p·k)`` shape (either way round).
    With ``weight_side`` only a pure operand counts."""

    name = "DenseFallbackDot"

    def __init__(self, dense_shapes: Iterable[Tuple[int, int]],
                 weight_side: bool = True):
        shapes = {tuple(int(d) for d in s) for s in dense_shapes}
        self.dense_shapes = shapes | {(o, i) for (i, o) in shapes}
        self.weight_side = bool(weight_side)

    def check(self, trace) -> List[Violation]:
        out = []
        for op in iter_ops(trace):
            if op.name not in DOT_OPS:
                continue
            for shape, pure in zip(op.in_shapes, op.in_pure):
                if self.weight_side and not pure:
                    continue
                if len(shape) == 2 and shape in self.dense_shapes:
                    out.append(_flag(
                        self.name,
                        f"{op.name} against a {shape} operand — the "
                        f"dense-equivalent kernel of a circulant layer "
                        f"(silent O(n^2) fallback)", op))
                    break
        return out


class LaunchBudget:
    """Exact (or bounded) number of kernel launches in the capture."""

    name = "LaunchBudget"

    def __init__(self, exact: Optional[int] = None,
                 max_launches: Optional[int] = None):
        if (exact is None) == (max_launches is None):
            raise ValueError("LaunchBudget takes exactly one of "
                             "exact= / max_launches=")
        self.exact, self.max_launches = exact, max_launches

    def check(self, trace) -> List[Violation]:
        launches = [op for op in iter_ops(trace) if op.name in LAUNCH_OPS]
        n = len(launches)
        budget = self.exact if self.exact is not None else self.max_launches
        over = (n != self.exact if self.exact is not None
                else n > self.max_launches)
        if not over:
            return []
        kind = "exactly" if self.exact is not None else "at most"
        # point at the first launch beyond the budget when there is one:
        # the launch a regression added
        culprit = launches[budget] if n > budget else (
            launches[-1] if launches else None)
        return [_flag(self.name,
                      f"{n} kernel launches, contract requires {kind} "
                      f"{budget}", culprit)]


class NoWeightConcat:
    """No in-capture ``cat`` assembling weight tables.

    Strict (no arguments): no ``cat`` at all, for pure-kernel surfaces.
    Serve: ``table_shapes`` (the fused ``(Σp, q, K)`` tables of the frozen
    params) and ``weight_side=True``: a ``cat`` is flagged when it
    produces a stacked-table shape from pure inputs only; activation
    concats pass."""

    name = "NoWeightConcat"

    def __init__(self,
                 table_shapes: Optional[Iterable[Tuple[int, ...]]] = None,
                 weight_side: bool = False):
        self.table_shapes = (
            None if table_shapes is None
            else {tuple(int(d) for d in s) for s in table_shapes})
        self.weight_side = bool(weight_side)

    def check(self, trace) -> List[Violation]:
        out = []
        for op in iter_ops(trace):
            if op.name != "aten.cat":
                continue
            shape = op.out_shapes[0]
            if self.table_shapes is not None and \
                    shape not in self.table_shapes:
                continue
            if self.weight_side and not op.pure:
                continue
            out.append(_flag(
                self.name,
                f"cat producing {shape} — fused weight groups must be "
                f"pre-concatenated once by freeze_params, not stacked on "
                f"every call", op))
        return out


class QuantizedTableDtypes:
    """Frozen-table dtype contract over a params tree (value rule).

    ``mode='int8'``: every frozen group (a dict carrying ``wr``/``wi``)
    stores int8 tables with a float32 ``w_scale``. ``mode='off'``: float
    tables and no scale."""

    name = "QuantizedTableDtypes"

    def __init__(self, mode: str = "int8"):
        if mode not in ("off", "int8"):
            raise ValueError(f"unknown quantize mode {mode!r}")
        self.mode = mode

    def check_params(self, params) -> List[Violation]:
        out: List[Violation] = []

        def visit(node, path):
            if isinstance(node, dict):
                if "wr" in node and "wi" in node:
                    out.extend(self._check_group(node, path))
                for k, v in node.items():
                    visit(v, path + (str(k),))
            elif isinstance(node, (tuple, list)):
                for i, v in enumerate(node):
                    visit(v, path + (str(i),))

        visit(params, ())
        return out

    def _check_group(self, group: dict, path) -> List[Violation]:
        loc = "/".join(path) or "<root>"
        wr, wi = group["wr"], group["wi"]
        scale = group.get("w_scale")
        bad = []
        name = lambda dt: str(dt).replace("torch.", "")
        if self.mode == "int8":
            if scale is None:
                bad.append(f"frozen table {loc!r} has no w_scale under "
                           f"quantize='int8'")
            else:
                if scale.dtype != torch.float32:
                    bad.append(f"{loc}/w_scale is {name(scale.dtype)}, "
                               f"contract requires float32")
                for key, t in (("wr", wr), ("wi", wi)):
                    if t.dtype != torch.int8:
                        bad.append(f"{loc}/{key} is {name(t.dtype)}, "
                                   f"contract requires int8")
        else:
            if scale is not None:
                bad.append(f"frozen table {loc!r} carries w_scale under "
                           f"quantize='off'")
            for key, t in (("wr", wr), ("wi", wi)):
                if not t.dtype.is_floating_point:
                    bad.append(f"{loc}/{key} is {name(t.dtype)}, contract "
                               f"requires a float dtype")
        return [Violation(rule=self.name, message=m) for m in bad]
