"""Multi-tenant asyncio front-end: admission, fairness, SLOs, backoff.

The engine (and its :class:`~repro_torch.serve.supervisor.Supervisor`
wrapper) is synchronous and single-stepped: the right shape for a
device-bound inner loop, the wrong one for heavy traffic from many users.
:class:`AsyncFrontend` is the concurrency layer on top of the unchanged
``submit/step/poll/drain`` API:

* **Per-tenant admission** — each tenant gets a token bucket
  (``rate``/``burst`` from its :class:`TenantConfig`); a submit first pays
  one bucket token (awaiting refill when empty), so one tenant's burst
  cannot monopolise the engine's admission queue.
* **Backpressure-aware submit** — ``await frontend.submit(...)`` turns the
  engine's :class:`~repro_torch.serve.guard.QueueFullError` into a bounded
  retry with jitter, sleeping ``retry_after_hint`` (the engine's
  queue-depth over drain-rate estimate) scaled by the attempt, and raises
  :class:`TenantRejectedError` (tenant-scoped, with the attempt count and
  the last hint) once the budget is spent.
* **SLO classes** — ``interactive``/``standard``/``batch`` map to a
  default ``Request.deadline_ms`` and a DRR fairness weight
  (:data:`SLO_CLASSES`); a request that sets its own ``deadline_ms`` keeps
  it. The matching ``tenant_weights`` for ``ServeEngine(policy="fair",
  ...)`` come from :meth:`AsyncFrontend.tenant_weights`.
* **Run loop** — :meth:`run` steps the engine while work remains,
  yielding to the event loop between steps so concurrent ``submit`` /
  ``stream`` coroutines interleave; :meth:`stream` yields each request's
  new tokens as they appear (through the supervisor's at-most-once
  ``take_new_tokens`` when there is one, else ``poll`` with a local
  high-water mark).

Determinism: every sleep goes through an injectable ``sleep`` coroutine
and the jitter through a seeded ``random.Random``, so tests drive the
whole front-end on a manual clock without wall-clock waits. Pure Python:
the device work is the engine's.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import time
from typing import (AsyncIterator, Callable, Dict, List, Optional, Tuple)

from repro_torch.serve.engine import Request, RequestState
from repro_torch.serve.guard import TERMINAL_STATES, QueueFullError

__all__ = [
    "SLO_CLASSES", "SLOClass", "TenantConfig", "TokenBucket",
    "TenantRejectedError", "AsyncFrontend",
]


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A latency/priority service class: the default request deadline
    and the tenant's weighted-DRR share (``Scheduler`` ``fair`` policy
    quantum)."""
    name: str
    deadline_ms: Optional[float]   # None = no deadline (batch)
    weight: int


SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", deadline_ms=2000.0, weight=4),
    "standard": SLOClass("standard", deadline_ms=10000.0, weight=2),
    "batch": SLOClass("batch", deadline_ms=None, weight=1),
}


@dataclasses.dataclass
class TenantConfig:
    """Per-tenant admission policy: SLO class plus token-bucket rate
    limiting (``rate`` submits/second sustained, ``burst`` back-to-back).
    """
    name: str
    slo: str = "standard"
    rate: float = 100.0
    burst: int = 10

    def __post_init__(self):
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {self.slo!r} for tenant "
                f"{self.name!r}; choose from {sorted(SLO_CLASSES)}")
        if self.rate <= 0 or self.burst < 1:
            raise ValueError(
                f"tenant {self.name!r} needs rate > 0 and burst >= 1 "
                f"(got rate={self.rate}, burst={self.burst})")

    @property
    def slo_class(self) -> SLOClass:
        return SLO_CLASSES[self.slo]


class TokenBucket:
    """Classic token bucket on an injectable clock: ``try_take`` is the
    non-blocking probe, ``wait_time`` says how long until a token
    accrues. Refill is continuous (``rate`` tokens/second, capped at
    ``burst``)."""

    def __init__(self, rate: float, burst: int,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self.clock()
        dt = now - self._last
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
            self._last = now

    def try_take(self) -> bool:
        self._refill()
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def wait_time(self) -> float:
        """Seconds until one token is available (0 if one already is)."""
        self._refill()
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


class TenantRejectedError(RuntimeError):
    """Tenant-scoped terminal rejection: the bounded retry budget for
    this submit is exhausted (engine queue stayed full) — shed THIS
    tenant's request without touching other tenants' traffic."""

    def __init__(self, tenant: str, attempts: int,
                 last_hint: Optional[float]):
        self.tenant = tenant
        self.attempts = int(attempts)
        self.last_hint = last_hint
        hint = ("" if last_hint is None
                else f"; engine suggested retry_after={last_hint:.3g}s")
        super().__init__(
            f"tenant {tenant!r}: request rejected after {attempts} "
            f"admission attempts (queue full){hint}")


class AsyncFrontend:
    """Asyncio front-end for a :class:`ServeEngine` or
    :class:`~repro_torch.serve.supervisor.Supervisor` (anything with
    ``submit/step/poll``; ``take_new_tokens`` is used when present).

    ``tenants`` maps tenant name to :class:`TenantConfig`; unknown
    tenants are rejected at submit (explicit registration is the
    admission contract). ``sleep``/``clock``/``rng`` are injectable for
    deterministic tests.
    """

    def __init__(self, engine, tenants: Dict[str, TenantConfig], *,
                 max_retries: int = 4,
                 base_backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0,
                 jitter: float = 0.25,
                 seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Optional[Callable[[float], "asyncio.Future"]] = None):
        if not tenants:
            raise ValueError("AsyncFrontend needs at least one tenant")
        self.engine = engine
        self.tenants = dict(tenants)
        self.max_retries = int(max_retries)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.clock = clock
        self.sleep = sleep if sleep is not None else asyncio.sleep
        self._rng = random.Random(seed)
        self._buckets = {
            name: TokenBucket(cfg.rate, cfg.burst, clock=clock)
            for name, cfg in self.tenants.items()
        }
        self.rejections: Dict[str, int] = {name: 0 for name in self.tenants}

    def tenant_weights(self) -> Dict[str, int]:
        """The ``ServeEngine(tenant_weights=...)`` dict implied by each
        tenant's SLO class — build the engine's ``fair`` scheduler from
        the same source of truth as the front-end."""
        return {name: cfg.slo_class.weight
                for name, cfg in self.tenants.items()}

    # -- admission ----------------------------------------------------------
    def _prepare(self, tenant: str, request: Request) -> Request:
        cfg = self.tenants.get(tenant)
        if cfg is None:
            raise KeyError(
                f"unregistered tenant {tenant!r}; registered: "
                f"{sorted(self.tenants)}")
        updates: Dict[str, object] = {}
        if request.tenant != tenant:
            updates["tenant"] = tenant
        if request.deadline_ms is None \
                and cfg.slo_class.deadline_ms is not None:
            updates["deadline_ms"] = cfg.slo_class.deadline_ms
        return dataclasses.replace(request, **updates) if updates \
            else request

    def _backoff(self, attempt: int, hint: Optional[float]) -> float:
        """Proportional backoff: the engine's hint when it has one
        (scaled by attempt), else exponential from ``base_backoff_s``;
        ± ``jitter`` fraction either way, capped at ``max_backoff_s``."""
        base = (hint * (attempt + 1) if hint is not None
                else self.base_backoff_s * (2.0 ** attempt))
        base *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, min(self.max_backoff_s, base))

    async def submit(self, tenant: str, request: Request) -> int:
        """Admit one request: pay the tenant's bucket token (awaiting
        refill), stamp the SLO deadline, then submit with bounded
        retry-with-jitter on :class:`QueueFullError`. Returns the engine
        (or supervisor) rid; raises :class:`TenantRejectedError` when
        the retry budget is spent."""
        request = self._prepare(tenant, request)
        bucket = self._buckets[tenant]
        while not bucket.try_take():
            await self.sleep(bucket.wait_time())
        last_hint: Optional[float] = None
        for attempt in range(self.max_retries + 1):
            try:
                return self.engine.submit(request)
            except QueueFullError as e:
                last_hint = e.retry_after_hint
                if attempt >= self.max_retries:
                    break
                await self.sleep(self._backoff(attempt, last_hint))
        self.rejections[tenant] += 1
        raise TenantRejectedError(tenant, self.max_retries + 1, last_hint)

    # -- driving ------------------------------------------------------------
    async def run(self, *, idle_rounds: int = 1) -> int:
        """Step the engine until it reports no work for ``idle_rounds``
        consecutive rounds, yielding to the event loop between steps so
        submit/stream coroutines interleave. Returns steps taken."""
        steps = 0
        idle = 0
        while idle < idle_rounds:
            if self.engine.step():
                idle = 0
            else:
                idle += 1
            steps += 1
            await self.sleep(0)
        return steps

    def _take_new(self, rid: int,
                  mark: List[int]) -> Tuple[List[int], RequestState]:
        take = getattr(self.engine, "take_new_tokens", None)
        if take is not None:
            return take(rid)
        st = self.engine.poll(rid)
        toks = list(st.tokens)
        new = toks[mark[0]:]
        mark[0] = max(mark[0], len(toks))
        return new, st

    async def stream(self, rid: int) -> AsyncIterator[int]:
        """Yield the request's tokens as they appear, exactly once each,
        until it terminates. Pair with a concurrently-running
        :meth:`run`."""
        mark = [0]
        while True:
            new, st = self._take_new(rid, mark)
            for t in new:
                yield t
            if st.status in TERMINAL_STATES:
                return
            await self.sleep(0)

    async def result(self, rid: int) -> RequestState:
        """Await a request's terminal state (drive with :meth:`run`)."""
        mark = [0]
        while True:
            _, st = self._take_new(rid, mark)
            if st.status in TERMINAL_STATES:
                return st
            await self.sleep(0)
