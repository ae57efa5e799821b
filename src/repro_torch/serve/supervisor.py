"""Self-healing engine supervision: fatal → restore → re-queue → resume.

An engine that raises :class:`~repro_torch.serve.guard.EngineFatalError`
refuses all further work; ``snapshot()``/``restore()`` move its whole
serving state to a replacement. The :class:`Supervisor` closes that loop
for the always-on deployment shape the paper targets (FPGA/IoT streaming,
C-LSTM's continuous ASR, arXiv:1803.06305):

* **Ownership** — the supervisor holds the engine and an engine
  ``factory``; callers use the supervisor's ``submit/step/poll/drain`` and
  never touch a dead engine.
* **Self-heal** — a ``step()`` (or ``submit()``) that raises
  ``EngineFatalError`` builds a replacement from the factory and restores
  the newest snapshot it accepts, walking back past refused ones. Work
  submitted after that snapshot (which the engine forgot) is re-submitted
  in submit order under fresh engine rids: the supervisor keeps its own
  rid namespace and a remap table, so caller handles survive any number
  of heals.
* **At-most-once emission** — a restore rolls token streams back to the
  snapshot; deterministic decoding (greedy argmax, or the per-request RNG
  state the snapshot carries) regenerates the same tokens.
  :meth:`take_new_tokens` keeps a per-request high-water mark and returns
  only tokens beyond it, so a consumer sees every token exactly once
  across heals.
* **Warm restart** — with a :class:`~repro_torch.serve.prefix_store.
  PrefixStore` attached to the engines, the replacement adopts the hottest
  spilled prefix donors (``engine.adopt_prefixes``) before taking traffic.

The dead engine is dropped at the heal: nothing in the supervisor keeps a
reference to it, so its slot state (the K/V cache on the card) and its
frozen tables are freed. The supervisor is single-threaded and
synchronous, as the engine is; the asyncio front-end
(:mod:`repro_torch.serve.frontend`) drives either one.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.ft.checkpoint import available_steps
from repro_torch.serve.engine import Request, RequestState, ServeEngine
from repro_torch.serve.guard import (TERMINAL_STATES, EngineFatalError,
                                     QueueFullError)

__all__ = ["Supervisor", "SupervisorGaveUp", "dataclass_replace_rid"]


class SupervisorGaveUp(RuntimeError):
    """The engine died more than ``max_restarts`` times; the last fatal is
    chained. Work already delivered stays delivered (the at-most-once
    ledger survives), but the supervisor stops healing."""


class Supervisor:
    """Wrap a :class:`ServeEngine` (or anything engine-shaped) with
    automatic fatal recovery.

    ``factory`` builds a fresh, identically configured engine; it is
    called once at construction and once per heal. Engines must be built
    with a ``snapshot_dir`` (the heal restores the latest snapshot;
    without snapshots every heal replays from scratch, which converges but
    repays all compute); ``require_snapshots=False`` allows the
    replay-from-scratch mode explicitly.

    Request ids are the supervisor's OWN namespace: ``submit`` returns a
    supervisor rid, and every public method takes supervisor rids; each
    maps to the current engine's rid (a re-submission after a heal
    re-maps it).
    """

    def __init__(self, factory: Callable[[], ServeEngine], *,
                 max_restarts: int = 3,
                 require_snapshots: bool = True):
        self.factory = factory
        self.max_restarts = int(max_restarts)
        self.engine = factory()
        if require_snapshots and self.engine.snapshot_dir is None:
            raise ValueError(
                "Supervisor needs engines built with snapshot_dir (the "
                "heal path restores the latest snapshot); pass "
                "require_snapshots=False to accept replay-from-scratch "
                "recovery")
        self.restarts = 0
        self._next = 0                            # supervisor rid namespace
        self._requests: Dict[int, Request] = {}   # submit-order ledger
        self._order: List[int] = []
        self._eng_rid: Dict[int, int] = {}        # sup rid -> engine rid
        self._emitted: Dict[int, int] = {}        # at-most-once high-water
        # terminal results claimed from a previous engine (drained there)
        # or carried across a heal; poll()/drain() serve these first
        self._final: Dict[int, RequestState] = {}
        # adopt stored prefixes into the cold first engine too
        self.engine.adopt_prefixes()

    # -- public API -------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Submit through to the engine; returns a SUPERVISOR rid (stable
        across heals). Backpressure (:class:`QueueFullError`) propagates
        to the caller (the async front-end turns it into bounded retry
        with jitter). A fatal raised by the submit path heals and retries
        once."""
        for attempt in (0, 1):
            try:
                eng_rid = self.engine.submit(request)
                break
            except QueueFullError:
                raise
            except EngineFatalError:
                if attempt:
                    raise
                self._heal()
        sup_rid = self._next
        self._next += 1
        self._requests[sup_rid] = request
        self._order.append(sup_rid)
        self._eng_rid[sup_rid] = eng_rid
        self._emitted[sup_rid] = 0
        return sup_rid

    def step(self) -> bool:
        """Advance the engine one round; heal on fatal. True while work
        remains (including the step a heal happened on)."""
        try:
            return self.engine.step()
        except EngineFatalError:
            self._heal()
            return True

    def poll(self, sup_rid: int) -> RequestState:
        """Engine ``poll`` by supervisor rid, served from the claimed
        ledger for requests drained before a heal."""
        if sup_rid in self._final:
            return self._final[sup_rid]
        if sup_rid not in self._eng_rid:
            raise KeyError(f"unknown request id {sup_rid}")
        st = self.engine.poll(self._eng_rid[sup_rid])
        return dataclass_replace_rid(st, sup_rid)

    def take_new_tokens(self, sup_rid: int) -> Tuple[List[int],
                                                     RequestState]:
        """The at-most-once stream: tokens beyond this request's
        high-water mark (empty while a healed engine regenerates tokens
        already delivered), and the current state. Every token is returned
        by exactly one call across any number of heals."""
        st = self.poll(sup_rid)
        mark = self._emitted.get(sup_rid, 0)
        toks = list(st.tokens)
        new = toks[mark:]
        if len(toks) > mark:
            self._emitted[sup_rid] = len(toks)
        return new, st

    def cancel(self, sup_rid: int) -> bool:
        if sup_rid in self._final:
            return False
        return self.engine.cancel(self._eng_rid[sup_rid])

    def drain(self, sup_rids: Optional[Sequence[int]] = None
              ) -> Dict[int, List[int]]:
        """Run to idle (healing as needed) and claim finished outputs by
        supervisor rid, as ``engine.drain`` does."""
        while self.step():
            pass
        if sup_rids is None:
            sup_rids = list(self._order)
        out: Dict[int, List[int]] = {}
        claim: List[int] = []
        for r in sup_rids:
            if r in self._final:
                out[r] = list(self._final[r].tokens)
            else:
                claim.append(r)
        if claim:
            # capture terminal states BEFORE engine.drain forgets them, so
            # later poll()/take_new_tokens() keep working
            states = {r: self.poll(r) for r in claim}
            got = self.engine.drain([self._eng_rid[r] for r in claim])
            for r in claim:
                self._final[r] = states[r]
                out[r] = got[self._eng_rid[r]]
        return out

    def snapshot(self) -> str:
        return self.engine.snapshot()

    @property
    def stats(self):
        return self.engine.stats

    # -- heal -------------------------------------------------------------
    def _heal(self) -> None:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise SupervisorGaveUp(
                f"engine died {self.restarts} times "
                f"(max_restarts={self.max_restarts}); last fatal: "
                f"{self.engine._fatal}")
        dead = self.engine
        self.engine = self.factory()
        if self.engine.snapshot_dir is not None:
            # newest snapshot first, walking back past any the engine
            # refuses (empty, corrupt, another version): a refused LATEST
            # must not strand recoverable older state
            for step in reversed(available_steps(self.engine.snapshot_dir)):
                try:
                    self.engine.restore(step)
                    break
                except FileNotFoundError:
                    break             # no snapshot at all: replay everything
                except ValueError:
                    continue          # refused this step; try an older one
        # warm-start on spilled prefix donors before taking traffic
        self.engine.adopt_prefixes()
        self._requeue_missing()
        del dead

    def _requeue_missing(self) -> None:
        """Re-submit, in submit order, every supervisor request the
        restored engine does not know: work submitted after the snapshot
        (or all work, without one). Its engine-side stream restarts from
        zero; the emission high-water mark makes redelivery impossible.
        Backpressure during the re-queue is absorbed by stepping the
        engine (queue space frees as slots drain)."""
        for sup_rid in self._order:
            if sup_rid in self._final:
                continue
            eng_rid = self._eng_rid[sup_rid]
            try:
                self.engine.poll(eng_rid)
                continue              # the snapshot carried it
            except KeyError:
                pass
            req = self._requests[sup_rid]
            while True:
                try:
                    self._eng_rid[sup_rid] = self.engine.submit(req)
                    break
                except QueueFullError:
                    self.engine.step()

    # -- ledger maintenance -----------------------------------------------
    def retire(self, sup_rid: int) -> None:
        """Forget a terminal, fully delivered request (frees the ledger;
        optional: one Request and two ints per id)."""
        st = self.poll(sup_rid)
        if st.status not in TERMINAL_STATES:
            raise ValueError(f"request {sup_rid} is not terminal")
        eng_rid = self._eng_rid.pop(sup_rid, None)
        if eng_rid is not None and sup_rid not in self._final:
            try:
                self.engine.drain([eng_rid])
            except KeyError:
                pass
        self._final.pop(sup_rid, None)
        self._requests.pop(sup_rid, None)
        self._emitted.pop(sup_rid, None)
        if sup_rid in self._order:
            self._order.remove(sup_rid)


def dataclass_replace_rid(st: RequestState, rid: int) -> RequestState:
    """``st`` with its request id replaced by ``rid``."""
    return RequestState(req_id=rid, done=st.done, tokens=st.tokens,
                        status=st.status, error=st.error)
