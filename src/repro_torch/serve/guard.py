"""Serving fault-tolerance primitives: request lifecycle states, error
classification, load-shedding backpressure, and the serve-path chaos
injector.

The engine (:mod:`repro_torch.serve.engine`) treats preemption, transient
device faults and overload as the normal operating regime. This module
holds the parts of its robustness layer that do not depend on the engine:

* **Lifecycle states** — every request ends in exactly one terminal state
  (:data:`TERMINAL_STATES`); ``FINISHED`` is the only success. The engine's
  ``poll`` surfaces the state plus a human-readable ``error`` reason.
* **Error classification** — :func:`classify_error` splits launch
  exceptions into ``"request"`` (raised *before* the launch touched the
  slot state: abort only the implicated requests and keep serving) and
  ``"fatal"`` (anything raised once the launch may have begun writing the
  state: the engine must die).
* **Backpressure** — :class:`QueueFullError` is the reject-new shedding
  signal: it carries the queue depth so callers can back off.
* **Chaos** — :class:`ServeFaultInjector` extends
  :class:`repro_torch.ft.driver.FaultInjector` with serve-path hooks
  (per-kind launch schedules, an engine-fatal schedule, artificial step
  delays, seeded random faults) so tests drive every failure path
  deterministically. :class:`ManualClock` makes deadline expiry testable
  without wall-clock sleeps.
* **State-tree serialization** — :func:`flatten_state_tree` /
  :func:`unflatten_state_tree` turn any runner state tree (the decoder
  runners' list of per-layer dicts, ``EncDecRunner``'s
  ``{"self": [...], "cross": [...]}``) into a flat string-keyed dict and
  back, so a snapshot never needs to know a family's tree shape.
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from typing import Iterable, Optional, Set, Tuple

import torch

from repro_torch.ft.driver import FaultInjector

__all__ = [
    "QUEUED", "RUNNING", "FINISHED", "FAILED", "EXPIRED", "CANCELLED",
    "TERMINAL_STATES",
    "QueueFullError", "EngineFatalError", "InjectedFault",
    "InjectedEngineFatal",
    "classify_error",
    "ManualClock",
    "ServeFaultInjector",
    "flatten_state_tree", "unflatten_state_tree",
]


# ---------------------------------------------------------------------------
# Generic runner-state serialization
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    """Leaves in canonical order: dict keys sorted, lists and tuples in
    order (the order ``jax.tree_util`` gives the reference's trees)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(template, it):
    if isinstance(template, Mapping):
        out = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, it) for t in template)
    return next(it)


def flatten_state_tree(tree) -> dict:
    """A state tree of tensors -> a flat ``{"s00000": leaf, ...}`` dict in
    canonical leaf order — deterministic across runs, so state taken from
    one engine rebuilds in a fresh engine built from the same config."""
    return {f"s{i:05d}": leaf for i, leaf in enumerate(_leaves(tree))}


def unflatten_state_tree(template, flat: dict):
    """Inverse of :func:`flatten_state_tree`: rebuild ``template``'s
    structure from the flat dict, each leaf a tensor with the template
    leaf's dtype and device."""
    t_leaves = _leaves(template)
    keys = [f"s{i:05d}" for i in range(len(t_leaves))]
    if sorted(flat) != keys:
        raise ValueError(
            f"snapshot state has {len(flat)} leaves, the runner's state "
            f"tree has {len(t_leaves)} — the snapshot was taken by a "
            f"different model family or config")
    leaves = [torch.as_tensor(flat[k]).to(dtype=t.dtype, device=t.device)
              for k, t in zip(keys, t_leaves)]
    return _rebuild(template, iter(leaves))


# ---------------------------------------------------------------------------
# Request lifecycle states
# ---------------------------------------------------------------------------

QUEUED = "QUEUED"          # submitted, waiting for a slot
RUNNING = "RUNNING"        # admitted to a cache slot, decoding
FINISHED = "FINISHED"      # terminal: ran to stop token / max_new
FAILED = "FAILED"          # terminal: isolated error (launch fault, NaN)
EXPIRED = "EXPIRED"        # terminal: deadline_ms exceeded
CANCELLED = "CANCELLED"    # terminal: cancel() or load shedding

TERMINAL_STATES = frozenset((FINISHED, FAILED, EXPIRED, CANCELLED))


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


class QueueFullError(RuntimeError):
    """Reject-new load shedding: the admission queue is at ``max_queue``.

    Backpressure signal — the request was NOT enqueued; the caller should
    retry after draining (``depth``/``max_queue`` say how far over).
    ``retry_after_hint`` (seconds, or None before the engine has observed
    any drain) estimates when a queue slot should free: queue depth over
    the engine's recently-observed drain rate."""

    def __init__(self, depth: int, max_queue: int,
                 retry_after_hint: Optional[float] = None):
        self.depth = int(depth)
        self.max_queue = int(max_queue)
        self.retry_after_hint = (None if retry_after_hint is None
                                 else float(retry_after_hint))
        hint = ("" if self.retry_after_hint is None
                else f" (retry_after_hint={self.retry_after_hint:.3g}s)")
        super().__init__(
            f"admission queue full ({depth} queued, max_queue={max_queue}); "
            f"request rejected — retry after the engine drains "
            f"(backpressure){hint}"
        )


class EngineFatalError(RuntimeError):
    """The engine hit an unrecoverable serving error (a launch may have
    written the slot state partway). The engine is dead and refuses
    further work; build a replacement engine."""


class InjectedFault(RuntimeError):
    """Chaos-injected *transient* launch failure. Raised BEFORE the launch
    runs, so the slot state is intact — classified ``"request"``
    (isolate, keep serving)."""


class InjectedEngineFatal(RuntimeError):
    """Chaos-injected engine-fatal fault — classified ``"fatal"``."""


def classify_error(e: BaseException) -> str:
    """``"request"`` | ``"fatal"`` for an exception raised around a
    prefill/decode launch.

    Only faults known to fire *before* the launch began writing the slot
    state (:class:`InjectedFault`) are request-isolatable; everything else
    — device errors, CUDA runtime errors, injected fatals — may have left
    a half-written cache and is engine-fatal."""
    return "request" if isinstance(e, InjectedFault) else "fatal"


# ---------------------------------------------------------------------------
# Deterministic clock (deadline tests / chaos without wall-clock sleeps)
# ---------------------------------------------------------------------------


class ManualClock:
    """Injectable monotonic clock: ``clock()`` reads, ``advance()`` moves.

    The engine takes any zero-arg callable returning seconds
    (``time.monotonic`` by default); tests pass a ManualClock so deadline
    expiry and step-delay injection are exact and instant."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.t += float(dt)
        return self.t


# ---------------------------------------------------------------------------
# Serve-path chaos injector
# ---------------------------------------------------------------------------


class ServeFaultInjector(FaultInjector):
    """Deterministic fault schedule for the serving path.

    * ``fail_prefill_at`` / ``fail_decode_at`` — successful-launch indices
      (the engine's ``stats.prefill_calls`` / ``stats.decode_steps`` at
      attempt time) at which :meth:`on_launch` raises a *transient*
      :class:`InjectedFault`. Each scheduled index fires at most once, so
      a retried decode launch succeeds on the second attempt.
    * ``fatal_decode_at`` / ``fatal_prefill_at`` — launch indices raising
      :class:`InjectedEngineFatal`.
    * ``delay_at`` / ``delay_s`` — engine step indices at which
      :meth:`on_step` injects an artificial stall: advancing the supplied
      ``clock`` (a :class:`ManualClock`) when given, else sleeping.
    * ``p_fail`` / ``seed`` — seeded random transient launch failures on
      top of the explicit schedule; the same seed reproduces the same
      fault pattern.

    Every ``launch_log`` entry is ``(kind, index, action, tenants)``: the
    engine passes the sorted tenants riding in each launch
    (``accepts_tenants`` advertises that signature, so injectors with the
    plain two-argument ``on_launch`` keep working).
    """

    accepts_tenants = True

    def __init__(self, fail_prefill_at: Iterable[int] = (),
                 fail_decode_at: Iterable[int] = (),
                 fatal_decode_at: Iterable[int] = (),
                 fatal_prefill_at: Iterable[int] = (),
                 delay_at: Iterable[int] = (), delay_s: float = 0.0,
                 p_fail: float = 0.0, seed: int = 0,
                 clock: Optional[ManualClock] = None):
        super().__init__(fail_at=(), delay_at=delay_at, delay_s=delay_s,
                         p_fail=p_fail, seed=seed)
        self.fail_prefill_at = set(int(i) for i in fail_prefill_at)
        self.fail_decode_at = set(int(i) for i in fail_decode_at)
        self.fatal_decode_at = set(int(i) for i in fatal_decode_at)
        self.fatal_prefill_at = set(int(i) for i in fatal_prefill_at)
        self.clock = clock
        self.launch_log: list = []  # (kind, index, action, tenants) audit

    def on_step(self, step: int) -> None:
        """Called at each engine step boundary: artificial step delays."""
        if step in self.delay_at:
            if self.clock is not None:
                self.clock.advance(self.delay_s)
            else:
                time.sleep(self.delay_s)

    def on_launch(self, kind: str, index: int,
                  tenants: Tuple[str, ...] = ()) -> None:
        """Called immediately BEFORE each prefill/decode launch (slot state
        still intact). Raises the scheduled fault, once per scheduled
        (kind, index). ``tenants`` is audit only."""
        key: Tuple[str, int] = (kind, int(index))
        tenants = tuple(tenants)
        if key in self.fired:
            return
        fatal: Set[int] = (self.fatal_prefill_at if kind == "prefill"
                           else self.fatal_decode_at)
        if index in fatal:
            self.fired.add(key)
            self.launch_log.append((kind, index, "fatal", tenants))
            raise InjectedEngineFatal(
                f"injected engine-fatal fault at {kind} launch {index}")
        sched: Set[int] = (self.fail_prefill_at if kind == "prefill"
                           else self.fail_decode_at)
        if index in sched:
            self.fired.add(key)
            self.launch_log.append((kind, index, "fail", tenants))
            raise InjectedFault(
                f"injected {kind} launch failure at launch {index}")
        if self.p_fail > 0.0 and self.rng.random() < self.p_fail:
            self.fired.add(key)
            self.launch_log.append((kind, index, "fail", tenants))
            raise InjectedFault(
                f"injected random {kind} launch failure at launch {index}")
        self.launch_log.append((kind, index, "ok", tenants))
