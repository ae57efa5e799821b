"""Per-surface structural contracts over the port's captured programs.

A :class:`Contract` names a surface (one function the port runs) and the
rules it must satisfy; ``audit_config`` builds every surface of one
registry config and returns the violations. The surface × rule table, the
reference's:

======================  =====================================================
surface                 rules
======================  =====================================================
plan_forward            NoFFT, NoDenseDotGeneral, LaunchBudget(1),
                        NoWeightConcat (strict) — a fused 3-projection
                        ``BCPlan`` forward at the config's block geometry.
plan_train_step         NoFFT, NoDenseDotGeneral, LaunchBudget(3: forward
                        + dx + dw), NoWeightConcat (strict) — the loss and
                        its gradient through a frozen plan, x requiring
                        grad (:func:`plan_surfaces`).
serve_prefill[...]      NoWeightFFT, DenseFallbackDot, NoWeightConcat
serve_decode[...]       (fused shapes); plus NoFFT when the config's impl is
                        kernel- or DFT-backed (``pallas``/``dft``); one
                        surface per engine bucket.
serve_params            QuantizedTableDtypes (the engine's quantize mode).
serve_launch_parity     int8 and f32 engines launch the same number of
                        kernels per bucket (the int8 dequant is in the
                        kernel) — across engines, so in ``audit_config``.
======================  =====================================================

The reference's ``serve_donation`` surface has no counterpart (the port
writes its cache in place and donates nothing; ``rules`` says more).

The port's serve surfaces are captures of ``engine.runner.prefill`` /
``decode`` on prewarm's synthetic rows (all-pad prefill rows, decode probes
at position -1), run on clones of the cache: an audit writes nothing the
engine holds and changes none of its stats, its prefix index or its
warm-shape sets. Since a capture runs the function, an audit costs one
forward per bucket, and it counts launches per layer run: a launch inside a
layer group repeated L times counts L times, where the reference's trace
of the scanned group holds it once.

``ServeEngine.audit()`` runs the ``serve_*`` single-engine surfaces for a
live engine (``prewarm(audit=True)`` runs it before any warm-up launch);
``python -m repro_torch.analysis`` runs everything for every registry
config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.rules import (LAUNCH_OPS, DenseFallbackDot,
                                        LaunchBudget, NoDenseDotGeneral, NoFFT,
                                        NoWeightConcat, NoWeightFFT,
                                        QuantizedTableDtypes, Violation)
from repro_torch.analysis.walker import Trace, capture

__all__ = ["Contract", "StructuralContractError", "run_contract",
           "circulant_table_shapes", "dense_equivalent_shapes",
           "fused_table_shapes", "plan_surfaces", "plan_step_without_dx",
           "audit_plan_surfaces", "serve_traces", "audit_engine",
           "launch_counts", "audit_config", "clone_tree", "FFT_FREE_IMPLS"]


class StructuralContractError(AssertionError):
    """Raised when an audit gate (prewarm / train step) finds
    violations; ``trace`` is the capture they were found in, where the
    gate had one."""

    def __init__(self, violations: Sequence[Violation], trace=None):
        self.violations = list(violations)
        self.trace = trace
        lines = "\n".join(f"  - {v}" for v in self.violations)
        super().__init__(
            f"{len(self.violations)} structural contract violation(s):\n"
            f"{lines}")


@dataclasses.dataclass(frozen=True)
class Contract:
    """A named surface and the rules that gate it."""

    name: str
    rules: Tuple[Any, ...]


def run_contract(contract: Contract, trace) -> List[Violation]:
    """Every rule of ``contract`` on one capture; violations come back
    stamped with the surface name."""
    return [dataclasses.replace(v, surface=contract.name)
            for rule in contract.rules for v in rule.check(trace)]


# ---------------------------------------------------------------------------
# Shape vocabularies from a model's specs / frozen params
# ---------------------------------------------------------------------------


def circulant_table_shapes(specs) -> List[Tuple[int, int, int]]:
    """Per-layer ``(p, q, k)`` table shapes of every circulant-tagged spec
    (expert lead dims stripped, as the tables reach a layer's launch)."""
    from repro_torch.nn.module import _walk

    return sorted({tuple(int(d) for d in spec.shape[-3:])
                   for _, spec in _walk(specs) if "circulant" in spec.tags})


def dense_equivalent_shapes(specs) -> List[Tuple[int, int]]:
    """``(in, out) = (q·k, p·k)`` dense kernels the circulant layers
    replaced, the shapes a silent dense fallback would contract against;
    shapes that a legitimately dense spec shares (MoE routers, an untied
    head, non-SWM projections) are left out, as in the reference: a rule
    that flags legitimate contractions gates nothing."""
    from repro_torch.nn.module import _walk

    legit = set()
    for _, spec in _walk(specs):
        if "circulant" not in spec.tags and len(spec.shape) >= 2:
            s = tuple(int(d) for d in spec.shape[-2:])
            legit |= {s, s[::-1]}
    return sorted({(q * k, p * k)
                   for (p, q, k) in circulant_table_shapes(specs)
                   if (q * k, p * k) not in legit})


def fused_table_shapes(params) -> List[Tuple[int, ...]]:
    """Shapes of every pre-concatenated fused frozen table in ``params``
    (the ``FUSED_KEY`` groups): the shapes an in-call weight concat would
    produce."""
    from repro_torch.kernels.block_circulant.plan import FUSED_KEY

    shapes = set()

    def visit(node):
        if isinstance(node, dict):
            fused = node.get(FUSED_KEY)
            if isinstance(fused, dict) and "wr" in fused:
                shapes.add(tuple(int(d) for d in fused["wr"].shape))
            for v in node.values():
                visit(v)

    visit(params)
    return sorted(shapes)


# ---------------------------------------------------------------------------
# Plan surfaces (the kernel path at the config's block geometry)
# ---------------------------------------------------------------------------


def _plan_geometry(cfg) -> Tuple[int, int, int]:
    from repro_torch.core.circulant import valid_block_size

    d = int(cfg.d_model)
    k = valid_block_size(int(cfg.swm.block_size), d, d)
    if k <= 1:
        raise ValueError(
            f"config {cfg.name!r} admits no circulant block on "
            f"(d_model={d}); plan surfaces need swm enabled")
    return d // k, d // k, k


def _plan_inputs(cfg, device):
    p, q, k = _plan_geometry(cfg)
    gen = torch.Generator().manual_seed(0)
    scale = (q * k) ** -0.5
    ws = [torch.randn((p, q, k), generator=gen) * scale for _ in range(3)]
    x = torch.randn((4, q * k), generator=gen)
    y = torch.randn((4, p * k), generator=gen)
    return k, [w.to(device) for w in ws], x.to(device), y.to(device)


def _plan_step(plan, x, y):
    """The loss of a plan forward and its gradient with respect to the
    tables (and x, when it requires grad)."""
    loss = ((plan.apply(x) - y) ** 2).mean()
    wrt = [plan.wr, plan.wi] + ([x] if x.requires_grad else [])
    return loss, torch.autograd.grad(loss, wrt)


def _strict_rules(launches: int):
    return (NoFFT(), NoDenseDotGeneral(), LaunchBudget(exact=launches),
            NoWeightConcat())


def _trainable_plan(w):
    from repro_torch.kernels.block_circulant import build_plan

    plan = build_plan(w)
    plan.wr.requires_grad_(True)
    plan.wi.requires_grad_(True)
    return plan


def plan_surfaces(cfg, device="cuda") -> List[Tuple[Contract, Any]]:
    """(contract, capture) pairs of the frozen-plan kernel path at this
    config's block geometry: a fused 3-projection forward (one launch),
    and the loss and gradient through a frozen plan (exactly 3 launches:
    forward, dx, dw). x requires grad there: the reference's custom VJP
    always computes dx, while torch autograd skips dx for an x that needs
    none (:func:`plan_step_without_dx`)."""
    from repro_torch.kernels.block_circulant import build_multi_plan

    k, ws, x, y = _plan_inputs(cfg, device)
    mp = build_multi_plan(ws)
    fwd = capture(mp.apply_multi, x, pure=[mp.wr, mp.wi])
    plan = _trainable_plan(ws[0])
    xg = x.clone().requires_grad_(True)
    step = capture(_plan_step, plan, xg, y, pure=[plan.wr, plan.wi])
    return [(Contract(f"plan_forward[k={k}]", _strict_rules(1)), fwd),
            (Contract(f"plan_train_step[k={k}]", _strict_rules(3)), step)]


def plan_step_without_dx(cfg, device="cuda") -> Tuple[Contract, Any]:
    """The plan train step with an x that requires no grad, a port-only
    surface: torch autograd computes no dx for it, so the step launches 2
    kernels (forward and dw), one fewer than the reference's custom VJP,
    which always launches the dx kernel too."""
    k, ws, x, y = _plan_inputs(cfg, device)
    plan = _trainable_plan(ws[0])
    step = capture(_plan_step, plan, x, y, pure=[plan.wr, plan.wi])
    return (Contract(f"plan_train_step_without_dx[k={k}]",
                     _strict_rules(2)), step)


def audit_plan_surfaces(cfg, device="cuda") -> List[Violation]:
    """Every plan surface's violations, the port-only one included."""
    pairs = plan_surfaces(cfg, device) + [plan_step_without_dx(cfg, device)]
    return [v for contract, trace in pairs
            for v in run_contract(contract, trace)]


# ---------------------------------------------------------------------------
# Serve surfaces (one live engine, every bucket)
# ---------------------------------------------------------------------------

#: impls whose whole dataflow is kernel- or matmul-backed: their serve
#: captures must hold no fft at all. The ``paper``/``freq`` impls stream
#: activations through rfft by design; for them only the weight side
#: (NoWeightFFT) is contractual.
FFT_FREE_IMPLS = ("pallas", "dft")


def clone_tree(tree):
    """A copy of a state, cache or params tree (dicts, lists, tuples):
    tensors cloned, leaves that require grad staying leaves that require
    grad; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def serve_traces(engine) -> List[Tuple[str, Any]]:
    """``(surface name, capture)`` for every prefill/decode bucket of a
    live engine: ``engine.runner.prefill``/``decode`` on prewarm's
    synthetic rows, on a clone of the cache, with the engine's frozen
    params as the pure tensors. Each capture keeps its ops only (not the
    logits)."""
    cache = clone_tree(engine.cache)
    t = engine._tensor
    pure = engine.params
    out = []
    for Sb in engine.prompt_buckets:
        for Bb in engine.batch_buckets:
            pos = np.repeat((np.arange(Sb, dtype=np.int32) - Sb)[None],
                            Bb, axis=0)
            slots = t(np.arange(Bb, dtype=np.int64))
            kw = {}
            if engine.prefix_cache:
                kw["donor_idx"] = slots
                kw["match_len"] = t(np.zeros(Bb, np.int32))
            ex = engine.runner.prewarm_extra(Bb)
            if ex is not None:
                kw["extra"] = ex
            trace = capture(engine.runner.prefill,
                            t(np.zeros((Bb, Sb), np.int64)), t(pos), cache,
                            slots, pure=pure, **kw)
            out.append((f"serve_prefill[B{Bb},S{Sb}]", Trace(trace.ops)))
    for Bb in engine.decode_buckets:
        trace = capture(engine.runner.decode,
                        t(np.zeros((Bb, 1), np.int64)), cache,
                        t(np.full(Bb, -1, np.int64)),
                        t(np.arange(Bb, dtype=np.int64)), pure=pure)
        out.append((f"serve_decode[B{Bb}]", Trace(trace.ops)))
    return out


def _serve_rules(engine) -> Tuple[Any, ...]:
    rules: List[Any] = [
        NoWeightFFT(),
        DenseFallbackDot(dense_equivalent_shapes(engine.runner.specs()),
                         weight_side=True),
        NoWeightConcat(fused_table_shapes(engine.params), weight_side=True),
    ]
    if engine.cfg.swm.impl in FFT_FREE_IMPLS:
        rules.insert(0, NoFFT())
    return tuple(rules)


def audit_engine(engine, traces=None) -> List[Violation]:
    """Every single-engine serve contract: each bucket's capture rules and
    the frozen-table dtype contract of the engine's quantize mode.
    ``traces`` (from :func:`serve_traces`) spares a second capture when
    the caller needs them too (launch parity)."""
    if not engine.cfg.swm.enabled:
        return []                       # dense config: nothing to promise
    rules = _serve_rules(engine)
    traces = serve_traces(engine) if traces is None else traces
    out = [v for name, trace in traces
           for v in run_contract(Contract(name=name, rules=rules), trace)]
    out += [dataclasses.replace(v, surface="serve_params")
            for v in QuantizedTableDtypes(engine.quantize).check_params(
                engine.params)]
    return out


def launch_counts(engine, traces=None) -> Dict[str, int]:
    """Kernel launches per bucket (for cross-engine parity)."""
    traces = serve_traces(engine) if traces is None else traces
    return {name: sum(1 for op in trace if op.name in LAUNCH_OPS)
            for name, trace in traces}


# ---------------------------------------------------------------------------
# Whole-config audit (the CLI's unit of work)
# ---------------------------------------------------------------------------


def _smoke_engine(cfg, params, quantize: str, device):
    from repro_torch.launch.specs import build_model
    from repro_torch.serve.engine import ServeEngine

    return ServeEngine(build_model(cfg, device=device), cfg, params,
                       batch=2, cache_len=32, prompt_buckets=(8,),
                       decode_buckets=(2,), quantize=quantize)


def audit_config(arch: str, quantize_legs: Sequence[str] = ("off", "int8"),
                 device="cuda") -> Dict[str, Any]:
    """Audit every surface of one registry config at its SMOKE shapes (the
    contracts are structural, so tiny geometry proves the same program
    structure) on ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain
    versions). Returns ``{"arch", "impl", "surfaces", "violations"}``; an
    empty ``violations`` list is the pass condition."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params

    cfg = get_smoke(arch)
    violations: List[Violation] = []
    surfaces: List[str] = []
    if cfg.swm.enabled:
        for contract, trace in plan_surfaces(cfg, device):
            surfaces.append(contract.name)
            violations.extend(run_contract(contract, trace))
    params = init_params(build_model(cfg, device=device).specs(), 0,
                         device=device)
    parity: Dict[str, Dict[str, int]] = {}
    for quantize in quantize_legs:
        if quantize != "off" and not cfg.swm.enabled:
            continue
        eng = _smoke_engine(cfg, params, quantize, device)
        traces = serve_traces(eng)
        tag = f"q={quantize}"
        surfaces.extend(f"{n}[{tag}]" for n, _ in traces)
        violations.extend(
            dataclasses.replace(v, surface=f"{v.surface}[{tag}]")
            for v in audit_engine(eng, traces=traces))
        parity[quantize] = launch_counts(eng, traces=traces)
    if "off" in parity and "int8" in parity:
        surfaces.append("serve_launch_parity")
        for name, n_off in parity["off"].items():
            n_q = parity["int8"].get(name)
            if n_q != n_off:
                violations.append(Violation(
                    rule="LaunchParity",
                    surface=f"serve_launch_parity[{name}]",
                    message=f"int8 engine launches {n_q} kernels where f32 "
                            f"launches {n_off} — the in-kernel dequant "
                            f"must add no launch"))
    return {"arch": arch,
            "impl": cfg.swm.impl if cfg.swm.enabled else "dense",
            "surfaces": surfaces,
            "violations": [v.to_json() for v in violations]}
