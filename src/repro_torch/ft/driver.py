"""Fault-tolerance primitives shared by training and serving.

* :class:`StragglerWatchdog` tracks per-step wall time with an EWMA; steps
  slower than ``mean + k·std`` (and 1.2x the mean) are flagged ``slow``,
  and ``max_consecutive`` slow steps in a row escalate. The serve engine
  counts flagged steps in ``EngineStats.slow_steps``.
* :class:`FaultInjector` is a deterministic fault schedule for tests:
  explicit steps plus seeded random faults (``p_fail``/``seed``), each
  step firing at most once, so a restarted run passes the step it died
  on. ``serve.guard.ServeFaultInjector`` extends it to the serve path.
* :class:`TrainDriver` wraps the train step in a supervisor loop:
  periodic async checkpoints (``tcfg.checkpoint_every``); on a step
  failure (a ``RuntimeError``: an injected fault, and every CUDA error
  PyTorch raises) it restores the latest checkpoint and resumes. Steps
  are idempotent because the data pipeline is keyed by step number. The
  port's train step updates the state's tensors in place, and they are
  the model's own buffers, so the restore copies the checkpoint into
  those tensors instead of handing back a fresh tree. On a mesh
  (``mesh=``, ``state_shardings=``) the sharded leaves (tensor-parallel
  and FSDP params, ZeRO-1 moments) are gathered whole on rank 0 one at a
  time for each checkpoint (``ft.checkpoint.gather_state``), and a
  restore reads back this rank's shard of each leaf
  (``restore_checkpoint(shardings=, mesh=)``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.ft.checkpoint import (AsyncCheckpointer, gather_state,
                                       latest_step, restore_checkpoint)

__all__ = ["TrainDriver", "StragglerWatchdog", "FaultInjector"]


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


def _load_into(state: dict, restored: dict, path: str = "") -> None:
    """Copy ``restored`` into ``state`` in place: tensor leaves by
    ``copy_`` (the model keeps training its own buffers), the Python int
    ``step`` replaced by its value."""
    if sorted(state) != sorted(restored):
        raise ValueError(
            f"checkpoint tree at {path or '<root>'!r} has keys "
            f"{sorted(restored)}, the train state has {sorted(state)}")
    for k, v in state.items():
        r = restored[k]
        if isinstance(v, dict):
            _load_into(v, r, f"{path}.{k}" if path else k)
        elif isinstance(v, torch.Tensor):
            with torch.no_grad():
                v.copy_(r)
        else:
            state[k] = int(r)


class TrainDriver:
    """Checkpointed auto-restart around ``train_step(state, batch)``.

    ``data_fn(step)`` gives the batch of a step. ``on_remesh(state)`` is
    called after the straggler watchdog escalates, with the state
    checkpointed first. ``metrics_log`` holds one ``{"step", "dt",
    "loss"}`` per executed step, replays after a restart included;
    ``restarts`` counts the restores. ``state_shardings`` (the per-dim
    specs of the layout the state is held in: the data-parallel step's
    ``train_step.data_parallel.state_shardings``) and ``mesh`` go
    together: checkpoints are written whole by rank 0 and restored as
    each rank's shard."""

    def __init__(self, train_step, tcfg: TrainConfig, data_fn,
                 state_shardings=None, mesh=None,
                 fault_injector: Optional[FaultInjector] = None,
                 on_remesh: Optional[Callable] = None):
        if (state_shardings is None) != (mesh is None):
            raise ValueError("TrainDriver takes state_shardings= and mesh= "
                             "together")
        self.state_shardings, self.mesh = state_shardings, mesh
        self.train_step = train_step
        self.tcfg = tcfg
        self.data_fn = data_fn                   # step -> batch
        self.ckpt = AsyncCheckpointer(tcfg.checkpoint_dir)
        self.watchdog = StragglerWatchdog()
        self.faults = fault_injector
        self.on_remesh = on_remesh
        self.restarts = 0
        self.metrics_log = []

    # ------------------------------------------------------------------
    def _save(self, step: int, state) -> None:
        """Checkpoint ``state`` at ``step``: on a mesh its sharded leaves
        gathered whole on rank 0, one at a time (``gather_state``, a
        collective every rank joins), and written by rank 0 only."""
        if self.mesh is not None:
            state = gather_state(state, self.state_shardings, self.mesh)
        if state is not None:
            self.ckpt.save(step, state)

    def _restore(self, state):
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()     # rank 0's checkpoint is on disk
        step = latest_step(self.tcfg.checkpoint_dir)
        if step is None:
            return state, 0
        restored = restore_checkpoint(self.tcfg.checkpoint_dir, step,
                                      shardings=self.state_shardings,
                                      mesh=self.mesh, device="cpu")
        _load_into(state, restored)
        return state, int(step)

    def run(self, state, n_steps: int, start_step: int = 0,
            max_restarts: int = 8):
        step = start_step
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if self.faults is not None:
                    self.faults.maybe_fire(step)
                batch = self.data_fn(step)
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])    # waits for the device
                dt = time.perf_counter() - t0
                verdict = self.watchdog.observe(step, dt)
                if verdict == "escalate" and self.on_remesh is not None:
                    self.ckpt.wait()
                    self._save(step + 1, state)
                    self.ckpt.wait()
                    state = self.on_remesh(state)
                self.metrics_log.append(
                    {"step": step, "dt": dt, "loss": loss})
                step += 1
                if step % self.tcfg.checkpoint_every == 0:
                    self._save(step, state)
            except RuntimeError:
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                self.ckpt.wait()
                state, step = self._restore(state)
        self.ckpt.wait()
        return state
