"""Fault-tolerance primitives shared by training and serving.

* :class:`StragglerWatchdog` tracks per-step wall time with an EWMA; steps
  slower than ``mean + k·std`` (and 1.2x the mean) are flagged ``slow``,
  and ``max_consecutive`` slow steps in a row escalate. The serve engine
  counts flagged steps in ``EngineStats.slow_steps``.
* :class:`FaultInjector` is a deterministic fault schedule for tests:
  explicit steps plus seeded random faults (``p_fail``/``seed``), each
  step firing at most once, so a restarted run passes the step it died
  on. ``serve.guard.ServeFaultInjector`` extends it to the serve path.

The reference's ``TrainDriver`` (checkpointed auto-restart around the
train step) needs ``ft/checkpoint.py`` and is not ported yet.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["StragglerWatchdog", "FaultInjector"]


class StragglerWatchdog:
    """EWMA step-time tracker; flags outliers and escalates."""

    def __init__(self, k: float = 3.0, max_consecutive: int = 3,
                 warmup: int = 5):
        self.k, self.max_consecutive, self.warmup = k, max_consecutive, warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.consecutive = 0
        self.events = []          # (step, dt, severity)

    def observe(self, step: int, dt: float) -> str:
        """Returns 'ok' | 'slow' | 'escalate'."""
        self.n += 1
        if self.n <= self.warmup:
            a = 1.0 / self.n
            self.mean += a * (dt - self.mean)
            self.var = max(self.var, (dt - self.mean) ** 2)
            return "ok"
        std = max(self.var, 1e-12) ** 0.5
        slow = dt > self.mean + self.k * std and dt > 1.2 * self.mean
        a = 0.1
        if not slow:              # don't poison stats with outliers
            self.mean += a * (dt - self.mean)
            self.var = (1 - a) * self.var + a * (dt - self.mean) ** 2
            self.consecutive = 0
            return "ok"
        self.consecutive += 1
        self.events.append((step, dt, "slow"))
        if self.consecutive >= self.max_consecutive:
            self.consecutive = 0
            self.events.append((step, dt, "escalate"))
            return "escalate"
        return "slow"


class FaultInjector:
    """Deterministic fault schedule for tests: raise at given steps.

    ``p_fail``/``seed`` layer seeded random faults on top of the explicit
    schedule: each ``maybe_fire`` call draws once from a private
    ``np.random.default_rng(seed)`` stream, so the same seed reproduces the
    same fault pattern. Each step fires at most once (``fired``)."""

    def __init__(self, fail_at=(), delay_at=(), delay_s: float = 0.0,
                 p_fail: float = 0.0, seed: int = 0):
        self.fail_at = set(fail_at)
        self.delay_at = set(delay_at)
        self.delay_s = delay_s
        self.p_fail = float(p_fail)
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.fired = set()

    def maybe_fire(self, step: int):
        if step in self.delay_at:
            time.sleep(self.delay_s)
        if step in self.fired:
            return
        if step in self.fail_at:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")
        if self.p_fail > 0.0 and self.rng.random() < self.p_fail:
            self.fired.add(step)
            raise RuntimeError(f"injected random fault at step {step}")
