"""Serving: continuous batching with bucketed launch shapes.

The paper keeps ``FFT(w)`` resident and streams only activations through
FFT → ∘ → IFFT. The engine applies that split at three levels:

* **Frozen frequency weights** — at construction the engine runs
  ``plan.freeze_params`` ONCE: every circulant table becomes its rfft
  ``(wr, wi)`` (the time-domain table is dropped) and is installed in the
  model, so no launch ever recomputes ``rfft(w)`` (counted by
  ``ops.freq_weights_trace_count``).
* **Bucketed shapes** — prefill batch sizes come from ``batch_buckets``
  (powers of two up to the slot count), prompt lengths round up to
  ``prompt_buckets``, and decode launches compact the active slots into the
  smallest ``decode_buckets`` batch that holds them. The set of launch
  shapes is therefore bounded (``max_prefill_variants`` /
  ``max_decode_variants``); ``prefill_compiles``/``decode_compiles`` count
  the distinct shapes launched (``prewarm()``'s included), the quantities
  a CUDA graph per bucket would capture. ``prewarm()`` launches every
  bucket shape once up front on an idle engine: one all-pad prefill per
  (batch bucket, prompt bucket), every position negative, and one decode
  probe per decode bucket at position -1. Every write it makes is masked
  (negative stored positions), and admission replaces a slot's rows
  whole, so a prewarmed engine serves the same tokens as a cold one; its
  launches are not counted in ``stats``.
* **The wave baseline** — :class:`WaveEngine` serves fixed waves of
  ``batch`` requests, each left-padded to its longest prompt (one launch
  shape per distinct wave length), every slot held until the wave's
  largest ``max_new``; greedy only. It shares the negative pad positions,
  so its greedy tokens equal the continuous engine's at the same launch
  shapes. :func:`make_prefill_step` / :func:`make_decode_step` are its
  model calls.
* **Continuous batching, streamed** — requests occupy independent cache
  slots; a finished slot admits the next queued request immediately.
  Admission order is a :class:`Scheduler` policy (fifo, sjf, or ``fair``:
  weighted deficit round-robin across ``Request.tenant``s, with
  ``tenant_weights``); each request carries its own
  :class:`SamplingParams` and stop tokens.
  ``submit`` / ``step`` / ``poll`` / ``drain`` serve an open-ended stream;
  ``cancel`` ends a queued or running request; ``generate(list)`` is a thin
  wrapper over that loop.
* **Shared-prefix KV reuse** (``prefix_cache=True``) — prompt heads another
  request already prefilled are not recomputed:

  1. *match* — admission looks the new prompt's block-aligned prefixes
     (multiples of ``prefix_block``, longest first) up in a host-side index
     of resident slot rows; a hit names a donor slot and a match length
     ``m`` (capped so the tail still produces the first-token logits and
     ``m + tail_bucket <= cache_len``, so the tail's pad writes stay clear
     of the copied rows);
  2. *copy rows* — the prefill gathers the donor's rows and masks every
     entry at position ``>= m`` (``pos -> -1``): a row copy instead of
     ``m`` tokens of recomputation (``EngineStats.prefill_tokens_saved``);
  3. *tail prefill* — only the unmatched tail runs through the model,
     bucket-shaped as usual, at positions ``m..L-1``;
  4. *pin* — a matched donor's rows are pinned (``_slot_refs``) until the
     launch that copies them has run: a pinned free slot is never handed
     to a new request and never borrowed as a decode pad lane;
  5. *evict* — rows leave the index when their slot is reassigned, is
     borrowed as a pad lane (least-recently-used donors first) or is
     scrubbed, or when the LRU index exceeds ``prefix_capacity``;
  6. *spill and adopt* — with a ``prefix_store``
     (:class:`~repro_torch.serve.prefix_store.PrefixStore`) an evicted
     donor's rows are copied to host memory first (never a scrubbed
     slot's), and ``adopt_prefixes`` places the store's hottest entries
     into a fresh engine's free slots and indexes them.

Padding: bucketed prefill left-pads prompts and numbers the pad positions
negatively, so attention masks them (and recurrent mixers skip them) and
greedy outputs are the same at every bucket shape. Decode compaction is a
pure permutation of slot rows, over every state leaf the runner holds (KV
caches, Mamba's conv and SSM states, RWKV's shift and WKV states).

Failure semantics (see :mod:`repro_torch.serve.guard`):

* **Terminal states** — every submitted request ends in exactly one of
  ``FINISHED``, ``FAILED`` (isolated error: launch fault or non-finite
  logits), ``EXPIRED`` (``deadline_ms`` exceeded) or ``CANCELLED``
  (``cancel()`` or load shedding); ``poll`` surfaces the state and the
  ``error`` reason, ``drain`` claims the (possibly partial) tokens.
* **Deadlines** — a step-boundary watchdog expires overdue requests,
  queued or running (the clock starts at ``submit``; ``clock`` is
  injectable, e.g. a :class:`~repro_torch.serve.guard.ManualClock`).
* **Error isolation** — every launch is wrapped and the error classified
  (``guard.classify_error``): a fault raised before the launch touched the
  state aborts only its chunk's requests (decode launches retry once);
  anything else is engine-fatal and the engine refuses further work. The
  port has no donated buffers — ``place_state`` writes the slot state in
  place — and keeps the split all the same: a failure after
  ``place_state`` began may leave a half-written cache. Non-finite logits
  are caught by the runner's per-row ``ok`` flag: only the poisoned row's
  request is ``FAILED``, its slot rows are scrubbed back to blank (a
  masked NaN still reaches attention through ``0·NaN``), and every other
  row continues unchanged.
* **Load shedding** — ``max_queue`` bounds admission; ``shed_policy``
  rejects new work (``QueueFullError`` with a ``retry_after_hint``) or
  cancels the longest-queued request (``drop-oldest``). ``generate``
  absorbs backpressure (step and retry).
* **SLO instrumentation** — ``EngineStats.ttft_ms`` (submit to first
  token) and ``tok_ms`` (inter-token gap) are :class:`LatencyHistogram`s;
  ``EngineStats.tenants`` holds each tenant's counters and TTFT histogram
  (:class:`TenantStats`).
* **Snapshot / restore** — ``snapshot()`` writes the whole serving state
  (slot state, slot table, scheduler queue with its DRR rotation, every
  request with its RNG state, deadlines as remaining budget, the prefix
  index, counters and histograms) through ``ft.checkpoint``'s atomics in
  the reference's format version 3; a replacement engine with the same
  configuration ``restore()``s it and resumes every decode mid-stream
  (``snapshot_every`` snapshots at step boundaries, skipping an empty
  engine).
* **Self-healing** — :class:`~repro_torch.serve.supervisor.Supervisor`
  rebuilds a dead engine from its factory, restores the newest snapshot
  it accepts, adopts stored prefixes and re-queues the rest, with
  at-most-once token streams; :mod:`repro_torch.serve.frontend` drives an
  engine or a supervisor from asyncio with per-tenant admission.

Everything model-shaped sits behind a :mod:`repro_torch.serve.runner`
runner. Requests of a family whose runner ``requires_extra`` (the enc-dec
family) carry their conditioning as ``Request.extra``, the encoder frames
``(enc_seq, d_model)``: the runner's ``validate_request`` checks it at
``submit``/``generate`` (decoder families refuse it), and a prefill
chunk's frames go to the runner stacked as f32 (and ride in a snapshot's
array section). ``audit()`` checks the structural contracts of every
bucket (:mod:`repro_torch.analysis.contracts`) and ``prewarm(audit=True)``
runs it before any warm-up launch.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import json
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.ft.checkpoint import latest_step as ckpt_latest_step
from repro_torch.ft.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.ft.driver import StragglerWatchdog
from repro_torch.kernels.block_circulant.plan import (_check_quantize,
                                                      freeze_params,
                                                      frozen_table_bytes)
from repro_torch.nn.module import load_tree
from repro_torch.serve.guard import (CANCELLED, EXPIRED, FAILED, FINISHED,
                                     QUEUED, RUNNING, TERMINAL_STATES,
                                     EngineFatalError, QueueFullError,
                                     classify_error, flatten_state_tree,
                                     unflatten_state_tree)
from repro_torch.serve.runner import make_runner, recurrent_mixer_names

__all__ = ["make_prefill_step", "make_decode_step", "SamplingParams",
           "Request", "RequestState", "Scheduler", "LatencyHistogram",
           "TenantStats", "EngineStats", "ServeEngine", "WaveEngine",
           "pow2_buckets",
           "pick_bucket", "batch_split", "validate_buckets", "QUEUED",
           "RUNNING", "FINISHED", "FAILED", "EXPIRED", "CANCELLED"]


# ---------------------------------------------------------------------------
# Step functions (the wave baseline's model calls)
# ---------------------------------------------------------------------------


def _serve_parallel(model, cfg: ModelConfig, mesh):
    if mesh is None:
        return None
    from repro_torch.dist.tensor_parallel import ServeParallel

    return ServeParallel.of(model, cfg, mesh)


def _on_rows(par, step, tokens, cache, *rest):
    """``step(tokens, cache, *rest)`` on this rank's rows of the global
    batch (``par``: a ``ServeParallel``, or None for the whole batch);
    ``rest`` holds per-row tensors or None."""
    if par is None:
        return step(tokens, cache, *rest)
    B = tokens.shape[0]
    a, b = par.step_rows(B, cache)
    with par.routing((a, b), B), par.layout(B, cache):
        return step(tokens[a:b], cache,
                    *(None if t is None else t[a:b] for t in rest))


def make_prefill_step(model, cfg: ModelConfig, mesh=None):
    """The prefill step over the tensors installed in ``model`` (the port
    keeps params in the model, so the step takes none).

    With ``mesh`` (a ``DeviceMesh`` with data axes and a ``model`` axis)
    the step is sharded as the reference's prefill under production
    shardings (``dist.tensor_parallel.ServeParallel``, which cuts the
    model's tensors to this rank's shards when they are whole): it takes
    the global tokens (and ``extra``, ``positions``) on every rank and
    this rank's cache shard (``prefill_step.parallel.init_cache``), and
    returns this rank's rows' last logits, whole over the vocabulary, and
    its cache shard. ``prefill_step.parallel`` is that ServeParallel (its
    ``log`` counts the collectives), None without a mesh."""
    par = _serve_parallel(model, cfg, mesh)

    def run(tokens, cache, extra, positions):
        if cfg.family == "encdec":
            logits, new_cache = model.forward(extra, tokens, cache=cache,
                                              logits_mode="last")
            return logits[:, -1], new_cache
        kwargs = {}
        if cfg.family == "vlm" and extra is not None:
            kwargs["img_embeds"] = extra
        logits, new_cache = model.forward(tokens, cache=cache,
                                          logits_mode="last",
                                          positions=positions, **kwargs)
        return logits[:, -1], new_cache

    @torch.no_grad()
    def prefill_step(tokens, cache, extra=None, positions=None):
        """tokens (B, S) -> (last logits (B, V), filled cache).

        ``positions`` (B, S) overrides the default ``0..S-1`` numbering;
        left-padded rows carry NEGATIVE pad positions, which attention
        masks and the cache stores masked. ``extra`` is the vlm's image
        prefix or the enc-dec's encoder frames (whose prefill numbers its
        tokens ``0..S-1``)."""
        return _on_rows(par, run, tokens, cache, extra, positions)

    prefill_step.parallel = par
    return prefill_step


def make_decode_step(model, cfg: ModelConfig, mesh=None):
    """The one-token decode step over the tensors installed in ``model``;
    with ``mesh``, sharded as :func:`make_prefill_step` is (the global
    ``tokens`` and ``pos``, this rank's cache shard and rows)."""
    par = _serve_parallel(model, cfg, mesh)

    @torch.no_grad()
    def decode_step(tokens, cache, pos):
        """tokens (B, 1), pos (B,) -> (logits (B, V), cache)."""
        return _on_rows(par, model.decode_step, tokens, cache, pos)

    decode_step.parallel = par
    return decode_step


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------


def pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    """Powers of two from ``lo``, always terminated by ``hi`` itself."""
    if hi < 1:
        raise ValueError(f"bucket upper bound must be >= 1, got {hi}")
    out = []
    b = max(1, int(lo))
    while b < hi:
        out.append(b)
        b *= 2
    out.append(int(hi))
    return tuple(sorted(set(out)))


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {max(buckets)}")


def batch_split(m: int, buckets: Sequence[int]) -> List[int]:
    """Greedy decomposition of ``m`` into bucket-sized chunks, largest
    first; a list that cannot cover the remainder raises ``ValueError``."""
    desc = sorted(set(int(b) for b in buckets), reverse=True)
    out: List[int] = []
    rem = int(m)
    while rem > 0:
        b = next((b for b in desc if b <= rem), None)
        if b is None:
            raise ValueError(
                f"batch buckets {sorted(desc)} cannot decompose {m}: no "
                f"bucket <= remainder {rem} (include 1 in the bucket list)")
        out.append(b)
        rem -= b
    return out


def validate_buckets(name: str, buckets: Sequence[int], hi: int,
                     *, require_hi: bool = True) -> Tuple[int, ...]:
    """Sorted unique ints in ``[1, hi]``, with ``hi`` appended when
    ``require_hi``; raises ``ValueError`` naming the list otherwise."""
    try:
        bk = tuple(sorted(set(int(b) for b in buckets)))
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be a sequence of ints; got {buckets!r}")
    if not bk or bk[0] < 1 or bk[-1] > hi:
        raise ValueError(f"{name} must lie in [1, {hi}]; got {bk}")
    if require_hi and bk[-1] != hi:
        bk = bk + (hi,)
    return bk


# ---------------------------------------------------------------------------
# Requests, sampling, scheduling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling. ``temperature <= 0`` means greedy argmax."""

    temperature: float = 0.0
    top_k: int = 0          # 0 = full vocab
    seed: int = 0

    def make_rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)


def _sample_token(logits: np.ndarray, sp: SamplingParams,
                  rng: np.random.Generator) -> int:
    if sp.temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits.astype(np.float64) / float(sp.temperature)
    vocab = z.shape[-1]
    # top_k == 0 or top_k >= vocab both mean the full vocabulary survives
    if 0 < sp.top_k < vocab:
        # exactly top_k candidates, ties at the k-th value broken toward
        # the lower token id
        kth = np.partition(z, -sp.top_k)[-sp.top_k]
        above = np.nonzero(z > kth)[0]
        ties = np.nonzero(z == kth)[0]
        keep = np.concatenate([above, ties[: sp.top_k - above.size]])
        masked = np.full_like(z, -np.inf)
        masked[keep] = z[keep]
        z = masked
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(p.shape[-1], p=p))


@dataclasses.dataclass
class Request:
    """``deadline_ms``: time to live from ``submit``; the step-boundary
    watchdog EXPIREs the request (queued or running) once it elapses.
    ``None`` means no deadline.

    ``extra``: per-request conditioning for families whose runner
    declares ``requires_extra`` — for enc-dec configs, the encoder frame
    embeddings with shape ``(enc_seq, d_model)``. Decoder-only families
    must leave it ``None`` (the runner's ``validate_request`` enforces
    both ways).

    ``tenant``: the tenant the request bills to (a non-empty string): the
    ``fair`` policy's queue key, the key of its ``EngineStats.tenants``
    slice, and part of the fault injector's audit log."""

    prompt: np.ndarray
    max_new: int = 16
    stop_tokens: Tuple[int, ...] = ()
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    deadline_ms: Optional[float] = None
    extra: Optional[np.ndarray] = None
    tenant: str = "default"

    def __post_init__(self):
        self.stop_tokens = tuple(int(t) for t in self.stop_tokens)
        self.tenant = str(self.tenant)
        if not self.tenant:
            raise ValueError("tenant must be a non-empty string")

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).reshape(-1).shape[0])


@dataclasses.dataclass(frozen=True)
class RequestState:
    """``poll`` snapshot: tokens so far, terminal flag, lifecycle
    ``status`` and, for failed terminals, the ``error`` reason. ``done`` is
    True exactly when ``status`` is terminal."""

    req_id: int
    done: bool
    tokens: Tuple[int, ...]
    status: str = QUEUED
    error: Optional[str] = None


def _validate_request(r: Request, cache_len: int) -> None:
    """Admission contract: no silent truncation, no zero budgets."""
    L = r.prompt_len
    if L == 0:
        raise ValueError("empty prompt")
    if r.max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {r.max_new}")
    if r.deadline_ms is not None and r.deadline_ms <= 0:
        raise ValueError(
            f"deadline_ms must be > 0 (or None for no deadline), "
            f"got {r.deadline_ms}")
    if L > cache_len:
        raise ValueError(
            f"prompt length {L} exceeds cache_len={cache_len}: the KV cache "
            f"cannot hold the prompt (raise cache_len or truncate the prompt)")
    # positions written: prompt 0..L-1, then decoded tokens L..L+max_new-2
    if L + r.max_new - 1 > cache_len:
        raise ValueError(
            f"prompt length {L} + max_new={r.max_new} needs "
            f"{L + r.max_new - 1} cache positions but cache_len={cache_len}: "
            f"the ring cache would silently overwrite live context "
            f"(raise cache_len or lower max_new)")


class Scheduler:
    """Admission queue: ``fifo``, ``sjf`` (shortest-prompt-first), or
    ``fair`` (weighted deficit round-robin across tenants). Per-request
    outputs are identical under every policy — slots are independent —
    only the admission order changes.

    ``fair`` keeps one FIFO queue per ``Request.tenant`` and admits by
    deficit round-robin: each rotation visit grants a tenant its
    ``tenant_weights`` quantum (default 1), so a backlogged tenant admits
    in proportion to its weight and every backlogged tenant is served at
    least once per full rotation; an idle tenant banks no deficit.

    ``max_queue`` bounds the queue depth (load shedding): a ``submit`` at
    the bound either raises :class:`QueueFullError` (``shed_policy
    "reject"`` — the item is NOT enqueued; it carries ``retry_hint()``
    when wired) or sheds the longest-queued item to make room
    (``"drop-oldest"``, returned to the caller to finalize). ``None``
    keeps the queue unbounded.

    Live items sit in ``_entries`` (seq -> entry); the policy heap
    (fifo/sjf), the per-tenant deques (fair) and the arrival-order heap
    behind ``drop_oldest`` hold seqs and delete lazily (dead seqs are
    skipped when popped). ``state_dict``/``load_state`` carry the whole
    queue and the DRR rotation through an engine snapshot."""

    POLICIES = ("fifo", "sjf", "fair")
    SHED_POLICIES = ("reject", "drop-oldest")

    def __init__(self, policy: str = "fifo",
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject",
                 tenant_weights: Optional[Dict[str, int]] = None,
                 retry_hint=None):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown scheduler policy {policy!r}; one of {self.POLICIES}")
        if shed_policy not in self.SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {shed_policy!r}; one of "
                f"{self.SHED_POLICIES}")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1 (or None for "
                             f"unbounded), got {max_queue}")
        if tenant_weights:
            if policy != "fair":
                raise ValueError(
                    f"tenant_weights only apply to the 'fair' policy "
                    f"(got policy={policy!r})")
            for t, w in tenant_weights.items():
                if int(w) < 1:
                    raise ValueError(
                        f"tenant weight must be >= 1; got {t!r}: {w}")
        self.policy = policy
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_policy = shed_policy
        self.tenant_weights = {str(t): int(w)
                               for t, w in (tenant_weights or {}).items()}
        self.retry_hint = retry_hint     # zero-arg callable -> seconds|None
        # seq -> (key, item, tenant, prompt_len)
        self._entries: Dict[int, Tuple[int, object, str, int]] = {}
        self._order: list = []           # lazy heap of (key, seq) [fifo/sjf]
        self._arrival: list = []         # lazy min-heap of seq [drop_oldest]
        self._tq: Dict[str, deque] = {}  # tenant -> deque of seq [fair]
        self._deficit: Dict[str, float] = {}
        self._rr: List[str] = []         # tenant rotation, first-seen order
        self._rr_pos = 0
        self._seq = 0
        self._front = 0

    def _key(self, prompt_len: int) -> int:
        return prompt_len if self.policy == "sjf" else 0

    def _insert(self, seq: int, key: int, item, tenant: str,
                prompt_len: int, *, front: bool = False) -> None:
        self._entries[seq] = (key, item, tenant, prompt_len)
        heapq.heappush(self._arrival, seq)
        if self.policy == "fair":
            q = self._tq.get(tenant)
            if q is None:
                q = self._tq[tenant] = deque()
                self._deficit.setdefault(tenant, 0.0)
                self._rr.append(tenant)
            (q.appendleft if front else q.append)(seq)
        else:
            heapq.heappush(self._order, (key, seq))

    def submit(self, item, prompt_len: int, tenant: str = "default"):
        """Enqueue; returns the item shed to make room (``drop-oldest`` at
        the bound) or None. Raises :class:`QueueFullError` at the bound
        under ``reject``."""
        dropped = None
        if self.max_queue is not None \
                and len(self._entries) >= self.max_queue:
            if self.shed_policy == "reject":
                hint = self.retry_hint() if self.retry_hint else None
                raise QueueFullError(len(self._entries), self.max_queue,
                                     retry_after_hint=hint)
            dropped = self.drop_oldest()
        self._insert(self._seq, self._key(prompt_len), item, str(tenant),
                     prompt_len)
        self._seq += 1
        return dropped

    def drop_oldest(self):
        """Remove and return the longest-queued item (smallest sequence
        number — arrival order, regardless of policy)."""
        while self._arrival:
            seq = heapq.heappop(self._arrival)
            e = self._entries.pop(seq, None)
            if e is not None:
                return e[1]
        raise IndexError("drop_oldest on an empty queue")

    def purge(self, keep) -> int:
        """Drop every queued item for which ``keep(item)`` is false
        (requests cancelled or expired while queued). Returns the number
        dropped; heap and deque references die lazily."""
        dead = [seq for seq, e in self._entries.items() if not keep(e[1])]
        for seq in dead:
            del self._entries[seq]
        return len(dead)

    def put_front(self, item, prompt_len: int,
                  tenant: str = "default") -> None:
        """Re-enqueue ahead of every same-key item (a request deferred out
        of an admission round goes back to the head of the line). Under
        ``fair`` the item returns to the head of its tenant's queue (its
        DRR quantum was charged when it was first taken)."""
        self._front -= 1
        self._insert(self._front, self._key(prompt_len), item, str(tenant),
                     prompt_len, front=True)

    def _take_ordered(self, n: int) -> list:
        out = []
        while self._order and len(out) < n:
            _, seq = heapq.heappop(self._order)
            e = self._entries.pop(seq, None)
            if e is not None:
                out.append(e[1])
        return out

    def _take_fair(self, n: int) -> list:
        out = []
        while self._entries and len(out) < n:
            t = self._rr[self._rr_pos % len(self._rr)]
            self._rr_pos = (self._rr_pos + 1) % len(self._rr)
            q = self._tq[t]
            while q and q[0] not in self._entries:
                q.popleft()              # lazily deleted (purged/shed) seqs
            if not q:
                # an idle tenant banks no deficit: credit accrues only
                # while backlogged, so a returning tenant cannot burst
                # past its weight
                self._deficit[t] = 0.0
                continue
            self._deficit[t] += float(self.tenant_weights.get(t, 1))
            while q and len(out) < n and self._deficit[t] >= 1.0:
                seq = q.popleft()
                e = self._entries.pop(seq, None)
                if e is None:
                    continue
                out.append(e[1])
                self._deficit[t] -= 1.0
            while q and q[0] not in self._entries:
                q.popleft()
            if not q:
                self._deficit[t] = 0.0
        return out

    def take(self, n: int) -> list:
        if self.policy == "fair":
            return self._take_fair(n)
        return self._take_ordered(n)

    def __len__(self) -> int:
        return len(self._entries)

    # -- serialization (engine snapshot/restore) ----------------------------
    def state_dict(self) -> Dict[str, object]:
        """Everything needed to rebuild the queue: live entries sorted by
        seq (front-pushed seqs are negative and order ahead of arrivals,
        matching the deque and heap pop order) plus the DRR rotation
        state. Items must be JSON-serializable (the engine queues int
        rids)."""
        return {
            "entries": [[int(seq), int(e[0]), e[1], e[2], int(e[3])]
                        for seq, e in sorted(self._entries.items())],
            "seq": int(self._seq),
            "front": int(self._front),
            "deficit": [[t, float(d)]
                        for t, d in sorted(self._deficit.items())],
            "rr": list(self._rr),
            "rr_pos": int(self._rr_pos),
        }

    def load_state(self, d: Dict[str, object]) -> None:
        """Inverse of :meth:`state_dict` into a fresh scheduler."""
        if self._entries:
            raise RuntimeError("load_state needs an empty scheduler")
        self._seq = int(d["seq"])
        self._front = int(d["front"])
        # seed the rotation before re-inserting, so the first-seen order
        # (the DRR visit order) survives for tenants whose entries were
        # all consumed
        for t in d.get("rr", []):
            if self.policy == "fair" and t not in self._tq:
                self._tq[t] = deque()
                self._deficit.setdefault(t, 0.0)
                self._rr.append(t)
        for seq, key, item, tenant, plen in d["entries"]:
            self._insert(int(seq), int(key), item, str(tenant), int(plen))
        for t, dv in d.get("deficit", []):
            if t in self._deficit or self.policy != "fair":
                self._deficit[t] = float(dv)
        self._rr_pos = int(d.get("rr_pos", 0))


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------


class LatencyHistogram:
    """Streaming latency histogram over FIXED log-spaced millisecond
    buckets (1-2-5 series, 10µs..100s, plus overflow): p50/p99 read in
    O(buckets) and memory is constant. Quantiles return the upper bound of
    the covering bucket — an upper estimate within the bucket spacing."""

    BOUNDS_MS: Tuple[float, ...] = tuple(
        m * (10.0 ** e) for e in range(-2, 5) for m in (1.0, 2.0, 5.0)
    ) + (1e5,)

    def __init__(self, counts: Optional[Sequence[int]] = None):
        n = len(self.BOUNDS_MS) + 1          # + overflow bucket
        if counts is None:
            self.counts = [0] * n
        else:
            if len(counts) != n:
                raise ValueError(
                    f"LatencyHistogram needs {n} bucket counts, "
                    f"got {len(counts)} — snapshot from a different "
                    f"bucket layout")
            self.counts = [int(c) for c in counts]

    @property
    def count(self) -> int:
        return sum(self.counts)

    def observe(self, ms: float) -> None:
        self.counts[bisect.bisect_left(self.BOUNDS_MS, float(ms))] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket containing the q-quantile (``None``
        on an empty histogram; ``inf`` when it falls in overflow)."""
        total = self.count
        if total == 0:
            return None
        target = q * total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return (self.BOUNDS_MS[i] if i < len(self.BOUNDS_MS)
                        else float("inf"))
        return float("inf")

    @property
    def p50(self) -> Optional[float]:
        return self.quantile(0.50)

    @property
    def p99(self) -> Optional[float]:
        return self.quantile(0.99)

    def as_dict(self) -> Dict[str, object]:
        return {"count": self.count, "p50_ms": self.p50, "p99_ms": self.p99}


@dataclasses.dataclass
class TenantStats:
    """Per-tenant slice of the engine counters plus a TTFT histogram."""

    submitted: int = 0
    admitted: int = 0                      # taken from the queue into a slot
    completed: int = 0
    rejected: int = 0
    expired: int = 0
    cancelled: int = 0
    aborted: int = 0
    tokens: int = 0
    ttft_ms: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    def as_dict(self) -> Dict[str, object]:
        return {
            "submitted": self.submitted, "admitted": self.admitted,
            "completed": self.completed, "rejected": self.rejected,
            "expired": self.expired, "cancelled": self.cancelled,
            "aborted": self.aborted, "tokens": self.tokens,
            "ttft": self.ttft_ms.as_dict(),
        }


@dataclasses.dataclass
class EngineStats:
    """Lifetime counters (never reset by ``generate``)."""

    prefill_calls: int = 0
    decode_steps: int = 0
    tokens_generated: int = 0
    requests_completed: int = 0
    padded_prompt_tokens: int = 0          # bucket-padding waste
    slot_steps_active: int = 0             # Σ over decode steps of active slots
    decode_rows: int = 0                   # Σ over decode steps of rows launched
    prefix_lookups: int = 0                # admissions probed against the index
    prefix_hits: int = 0                   # admissions seeded from a donor
    prefill_tokens_saved: int = 0          # Σ matched prefix tokens never rerun
    rejected: int = 0                      # load-shed submissions (both policies)
    aborted: int = 0                       # FAILED terminals (isolated errors)
    expired: int = 0                       # EXPIRED terminals (deadline_ms)
    cancelled: int = 0                     # CANCELLED terminals (cancel/shed)
    recoveries: int = 0                    # successful restore() calls
    snapshots: int = 0                     # snapshot() calls
    launch_retries: int = 0                # transient decode launches retried
    slow_steps: int = 0                    # straggler-watchdog flagged steps
    prefix_spills: int = 0                 # evicted donors spilled to store
    prefix_adoptions: int = 0              # store entries adopted into slots
    prefill_shapes: Set[Tuple[int, int]] = dataclasses.field(
        default_factory=set)
    decode_shapes: Set[int] = dataclasses.field(default_factory=set)
    ttft_ms: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)      # submit -> first token
    tok_ms: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)      # inter-token (decode) gap
    tenants: Dict[str, TenantStats] = dataclasses.field(
        default_factory=dict)

    def tenant(self, name: str) -> TenantStats:
        """Get-or-create the per-tenant slice."""
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = TenantStats()
        return ts

    @property
    def tokens_per_decode_step(self) -> float:
        """Mean decoded tokens per decode launch."""
        if self.decode_steps == 0:
            return 0.0
        return self.slot_steps_active / self.decode_steps

    @property
    def decode_rows_per_token(self) -> float:
        """Mean rows launched per generated token (decode work
        amplification; compaction pulls it toward 1)."""
        if self.tokens_generated == 0:
            return 0.0
        return self.decode_rows / self.tokens_generated

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prefix-index probes that found a usable donor."""
        if self.prefix_lookups == 0:
            return 0.0
        return self.prefix_hits / self.prefix_lookups


# ---------------------------------------------------------------------------
# The continuous-batching engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """Continuous batching over ``batch`` cache slots with bucketed shapes.

    ``params`` is the model's param tree (``model.specs()`` layout). The
    engine freezes it (``quantize`` "off" or "int8") and installs the
    frozen tree in ``model`` — one engine per model. Caches live on
    ``model.device``. ``prefix_cache``/``prefix_block``/``prefix_capacity``
    configure shared-prefix reuse and ``prefix_store`` its host spill
    target, ``max_queue``/``shed_policy`` load shedding,
    ``tenant_weights`` the ``fair`` policy's DRR weights,
    ``snapshot_dir``/``snapshot_every`` snapshots, ``fault_injector`` the
    chaos hooks (a :class:`~repro_torch.serve.guard.ServeFaultInjector`)
    and ``clock`` the deadline and latency clock (seconds,
    ``time.monotonic`` by default); see the module docstring.
    """

    def __init__(self, model, cfg: ModelConfig, params, batch: int,
                 cache_len: int, *,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 decode_buckets: Optional[Sequence[int]] = None,
                 policy: str = "fifo",
                 prefix_cache: bool = False,
                 prefix_block: int = 8,
                 prefix_capacity: int = 256,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject",
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0,
                 fault_injector=None,
                 clock=time.monotonic,
                 quantize: str = "off",
                 tenant_weights: Optional[Dict[str, int]] = None,
                 prefix_store=None):
        # fail fast on unknown policies / bad bounds (before param freeze)
        Scheduler(policy, max_queue=max_queue, shed_policy=shed_policy,
                  tenant_weights=tenant_weights)
        if int(snapshot_every) < 0:
            raise ValueError(
                f"snapshot_every must be >= 0, got {snapshot_every}")
        if int(snapshot_every) > 0 and snapshot_dir is None:
            raise ValueError("snapshot_every needs snapshot_dir")
        _check_quantize(quantize)
        if quantize != "off" and not cfg.swm.enabled:
            raise ValueError(
                "quantize applies to frozen circulant tables; this config "
                "has swm disabled")
        self.batch, self.cache_len = int(batch), int(cache_len)
        self.runner = make_runner(model, cfg, self.cache_len)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_block = int(prefix_block)
        self.prefix_capacity = int(prefix_capacity)
        if self.prefix_cache:
            if self.prefix_block < 1:
                raise ValueError(
                    f"prefix_block must be >= 1, got {prefix_block}")
            if self.prefix_capacity < 1:
                raise ValueError(
                    f"prefix_capacity must be >= 1, got {prefix_capacity}")
            if not self.runner.supports_prefix_cache:
                raise ValueError(
                    f"prefix_cache=True is unsupported for "
                    f"{type(self.runner).__name__}: "
                    f"{self.runner.prefix_cache_unsupported_reason}")
        if prefix_store is not None and not self.prefix_cache:
            raise ValueError(
                "prefix_store needs prefix_cache=True: the store spills "
                "and adopts prefix-index donor rows, which only exist "
                "with the prefix cache on")
        if cfg.swm.enabled:
            params = freeze_params(self.runner.specs(), params,
                                   quantize=quantize)
        load_tree(model, params)
        self.device = model.device
        self.quantize = quantize
        self.cfg, self.params = cfg, params
        self.policy = policy
        if prompt_buckets is None:
            prompt_buckets = pow2_buckets(min(8, self.cache_len),
                                          self.cache_len)
        self.prompt_buckets = validate_buckets(
            "prompt_buckets", prompt_buckets, self.cache_len)
        self.batch_buckets = pow2_buckets(1, self.batch)
        if decode_buckets is None:
            decode_buckets = self.batch_buckets
        self.decode_buckets = validate_buckets(
            "decode_buckets", decode_buckets, self.batch)
        self.stats = EngineStats()
        # shapes launched by prewarm(): counted by prefill_compiles /
        # decode_compiles, kept out of stats (and so out of snapshots)
        self._warm_prefill: Set[Tuple[int, int]] = set()
        self._warm_decode: Set[int] = set()
        # the last audit()'s captures, (surface, capture) per bucket
        self.audit_traces: List[Tuple[str, Any]] = []
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_policy = shed_policy
        self.tenant_weights = {str(t): int(w)
                               for t, w in (tenant_weights or {}).items()}
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        self.faults = fault_injector
        self.prefix_store = prefix_store
        self._clock_fn = clock
        self._watchdog = StragglerWatchdog()
        self._fatal: Optional[str] = None
        self._step_count = 0
        # drain-rate estimate (terminals/s EWMA) behind retry_after_hint;
        # per-rid submit/last-token times feed the latency histograms
        self._drain_rate = 0.0
        self._prev_step_t: Optional[float] = None
        self._prev_terminals = 0
        self._terminals = 0
        self._submit_t: Dict[int, float] = {}
        self._last_tok_t: Dict[int, float] = {}
        self._store_fp: Optional[str] = None
        self._sched = self._new_scheduler()
        self._next_rid = 0
        self._req: Dict[int, Request] = {}
        self._out: Dict[int, List[int]] = {}
        self._finished: Dict[int, List[int]] = {}
        self._status: Dict[int, str] = {}
        self._error: Dict[int, Optional[str]] = {}
        self._deadline: Dict[int, float] = {}
        self._rid_slot: Dict[int, int] = {}
        self._reset_slots()

    # -- launch-shape accounting --------------------------------------------
    @property
    def max_prefill_variants(self) -> int:
        return len(self.batch_buckets) * len(self.prompt_buckets)

    @property
    def max_decode_variants(self) -> int:
        return len(self.decode_buckets)

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill launch shapes so far, prewarm's included."""
        return len(self.stats.prefill_shapes | self._warm_prefill)

    @property
    def decode_compiles(self) -> int:
        """Distinct decode launch shapes so far, prewarm's included."""
        return len(self.stats.decode_shapes | self._warm_decode)

    def frozen_table_bytes(self) -> int:
        """Resident bytes of the frozen frequency tables (fused copies and
        int8 scales included)."""
        return frozen_table_bytes(self.params)

    # -- host-side slot state -------------------------------------------------
    def _reset_slots(self) -> None:
        B = self.batch
        self.cache = self.runner.init_state(B)
        self._active = np.zeros(B, bool)
        self._slot_req: List[Optional[int]] = [None] * B
        self._slot_rng: List[Optional[np.random.Generator]] = [None] * B
        self._slot_pos = np.zeros(B, np.int64)
        self._slot_last = np.zeros(B, np.int64)
        self._slot_left = np.zeros(B, np.int64)
        # prefix-cache state: resident prompt per slot, block-aligned
        # prefix index (LRU), donor pins, recency clock
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * B
        self._slot_refs = np.zeros(B, np.int64)
        self._slot_touch = np.zeros(B, np.int64)
        self._prefix_index: "OrderedDict[Tuple[int, bytes], int]" = \
            OrderedDict()
        self._clock = 0

    def _new_scheduler(self) -> Scheduler:
        return Scheduler(self.policy, max_queue=self.max_queue,
                         shed_policy=self.shed_policy,
                         tenant_weights=self.tenant_weights,
                         retry_hint=self.retry_after_hint)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- prefix index ---------------------------------------------------------
    def _index_drop_slot(self, slot: int, *, spill: bool = True) -> None:
        """Evict a slot's rows from the prefix index — called exactly when
        the rows are about to be overwritten (slot reassigned, borrowed as
        a decode pad lane, or scrubbed). Pinned rows never get here.

        With a ``prefix_store`` the evicted donor's rows are copied to the
        host store first (the last moment they are readable), except with
        ``spill=False``: the scrub path evicts poisoned rows, which must
        not outlive the engine."""
        assert self._slot_refs[slot] == 0, (
            f"evicting donor slot {slot} with {self._slot_refs[slot]} "
            f"in-flight references")
        if self._slot_prompt[slot] is None:
            return
        if spill and self.prefix_store is not None:
            rows = self.runner.gather_state(
                self.cache, self._tensor(np.asarray([slot], np.int64)))
            host = {k: v.cpu()
                    for k, v in flatten_state_tree(rows).items()}
            if self.prefix_store.put(self._slot_prompt[slot], host,
                                     self._store_fingerprint()):
                self.stats.prefix_spills += 1
        self._slot_prompt[slot] = None
        for key in [k for k, s in self._prefix_index.items() if s == slot]:
            del self._prefix_index[key]

    def _index_insert(self, slot: int, prompt: np.ndarray) -> None:
        """Register a freshly prefilled slot as a donor: every block-aligned
        prefix of its prompt maps to the slot, LRU-bounded by
        ``prefix_capacity`` (forgetting an entry never frees slot rows).
        Inert unless the runner supports prefix reuse."""
        if not self.prefix_cache or not self.runner.supports_prefix_cache:
            return
        self._slot_prompt[slot] = prompt
        self._clock += 1
        self._slot_touch[slot] = self._clock
        raw = prompt.tobytes()
        for m in range(self.prefix_block, prompt.shape[0] + 1,
                       self.prefix_block):
            key = (m, raw[: m * prompt.itemsize])
            self._prefix_index[key] = slot
            self._prefix_index.move_to_end(key)
        while len(self._prefix_index) > self.prefix_capacity:
            self._prefix_index.popitem(last=False)

    def _match_prefix(self, prompt: np.ndarray) -> Tuple[Optional[int], int]:
        """Longest usable indexed prefix of ``prompt``: a multiple of
        ``prefix_block``, at most ``L - 1`` (the tail must produce the
        first-token logits) and with ``m + tail_bucket <= cache_len`` (the
        tail's pad writes stay clear of the copied rows). Returns
        ``(donor_slot, m)`` or ``(None, 0)``."""
        if not self.prefix_cache or not self.runner.supports_prefix_cache \
                or not self._prefix_index:
            return None, 0
        L = int(prompt.shape[0])
        raw = prompt.tobytes()
        m = ((L - 1) // self.prefix_block) * self.prefix_block
        while m >= self.prefix_block:
            key = (m, raw[: m * prompt.itemsize])
            slot = self._prefix_index.get(key)
            if slot is not None:
                Sb = pick_bucket(L - m, self.prompt_buckets)
                if m + Sb <= self.cache_len:
                    self._prefix_index.move_to_end(key)
                    self._clock += 1
                    self._slot_touch[slot] = self._clock
                    return int(slot), m
            m -= self.prefix_block
        return None, 0

    def _store_fingerprint(self) -> str:
        """Geometry identity of prefix-store entries: runner class,
        cache_len, and the leaf shapes and dtypes (numpy's names) of a
        single-slot ``gather_state``. Adopting rows produced under another
        geometry raises in the store instead of placing mismatched
        state."""
        if self._store_fp is None:
            one = self.runner.gather_state(
                self.cache, self._tensor(np.zeros(1, np.int64)))
            leaves = [(list(t.shape), str(t.dtype).replace("torch.", ""))
                      for t in flatten_state_tree(one).values()]
            self._store_fp = json.dumps(
                {"runner": type(self.runner).__name__,
                 "cache_len": self.cache_len, "leaves": leaves},
                sort_keys=True)
        return self._store_fp

    def adopt_prefixes(self, max_slots: Optional[int] = None) -> int:
        """Warm-start free slots from the attached ``prefix_store``: place
        the hottest stored donor rows into unowned, unindexed, unpinned
        slots and register them in the prefix index, so the next
        admission round's ``_match_prefix`` finds them resident. Returns
        the number of slots adopted. The rows are placed with the runner's
        ``place_state``, so they are bit-identical to the rows the
        original engine held."""
        self._check_alive()
        if self.prefix_store is None or not self.prefix_cache:
            return 0
        budget = self.batch if max_slots is None else int(max_slots)
        free = [s for s in range(self.batch)
                if not self._active[s] and self._slot_refs[s] == 0
                and self._slot_prompt[s] is None]
        adopted = 0
        for prompt, rows in self.prefix_store.hottest():
            if not free or adopted >= budget:
                break
            if prompt.shape[0] > self.cache_len:
                continue
            # already resident? (a restored engine may still hold it)
            raw = prompt.tobytes()
            mtop = (prompt.shape[0] // self.prefix_block) \
                * self.prefix_block
            if mtop >= self.prefix_block and \
                    (mtop, raw[: mtop * prompt.itemsize]) \
                    in self._prefix_index:
                continue
            # geometry guard: the fingerprint was checked at put time, but
            # a loaded store meets the engine here
            self.prefix_store._check_fingerprint(
                self._store_fingerprint(), "adopt")
            sub = unflatten_state_tree(self.runner.init_state(1), rows)
            slot = free.pop(0)
            self.cache = self.runner.place_state(
                self.cache, sub, self._tensor(np.asarray([slot], np.int64)))
            self._index_insert(slot, prompt)
            self.prefix_store.touch(prompt)
            adopted += 1
            self.stats.prefix_adoptions += 1
        return adopted

    # -- backpressure ---------------------------------------------------------
    def retry_after_hint(self) -> Optional[float]:
        """Estimated seconds until a queue slot frees: queue depth over the
        observed drain rate (terminals/s EWMA across step boundaries).
        ``None`` until the engine has observed any drain."""
        if self._drain_rate <= 0.0:
            return None
        depth = max(1, len(self._sched))
        return float(min(60.0, max(1e-3, depth / self._drain_rate)))

    def _observe_drain(self, now: float) -> None:
        """EWMA the terminal-completion rate at each step boundary.
        Terminals accumulate until the clock advances (dt > 0), so a burst
        finishing inside one clock tick still registers."""
        if self._prev_step_t is None:
            self._prev_step_t = now
            return
        dt = now - self._prev_step_t
        if dt <= 0:
            return
        rate = (self._terminals - self._prev_terminals) / dt
        a = 0.2
        self._drain_rate = (rate if self._drain_rate == 0.0
                            else a * rate + (1 - a) * self._drain_rate)
        self._prev_step_t = now
        self._prev_terminals = self._terminals

    def _validate(self, r: Request) -> None:
        _validate_request(r, self.cache_len)
        self.runner.validate_request(r)

    # -- lifecycle --------------------------------------------------------------
    def _check_alive(self) -> None:
        if self._fatal is not None:
            raise EngineFatalError(
                f"engine is dead ({self._fatal}); build a replacement "
                f"engine and restore() its latest snapshot")

    def _die(self, e: BaseException) -> None:
        """Engine-fatal error: a launch may have written the slot state
        partway, so no device state can be trusted. Mark the engine dead
        (every later submit/step refuses) and raise."""
        self._fatal = f"{type(e).__name__}: {e}"
        raise EngineFatalError(
            f"engine-fatal serving error ({self._fatal}): the slot state "
            f"cannot be trusted after a mid-launch failure — the engine is "
            f"dead; build a replacement engine and restore() its latest "
            f"snapshot") from e

    def _scrub_slot(self, slot: int) -> None:
        """Overwrite a slot's rows with blank (fresh) rows. Needed after a
        non-finite launch row: NaN k/v contaminate any later read through
        attention even when masked (``0 · NaN = NaN``), including the
        no-match self-donor seed of the next prefill."""
        self.cache = self.runner.reset_rows(
            self.cache, self._tensor(np.asarray([slot], np.int64)))

    def _finalize(self, rid: int, status: str,
                  error: Optional[str] = None, *,
                  scrub: bool = False) -> None:
        """Move a request to a terminal state: free its slot if admitted
        (donor pins are zero whenever this runs), keep the slot's
        prefix-index entries unless ``scrub`` (non-finite rows: drop them
        from the index and blank the rows), bump the matching counter. The
        (possibly partial) tokens stay claimable via ``drain``."""
        assert status in TERMINAL_STATES, status
        slot = self._rid_slot.pop(rid, None)
        if slot is not None:
            self._active[slot] = False
            self._slot_req[slot] = None
            self._slot_rng[slot] = None
            if scrub:
                # poisoned rows: never spill them to the prefix store
                self._index_drop_slot(slot, spill=False)
                self._scrub_slot(slot)
        req = self._req.pop(rid, None)
        self._finished[rid] = self._out.pop(rid, [])
        self._deadline.pop(rid, None)
        self._submit_t.pop(rid, None)
        self._last_tok_t.pop(rid, None)
        self._status[rid] = status
        self._error[rid] = error
        self._terminals += 1
        ts = self.stats.tenant(req.tenant) if req is not None else None
        if status == FINISHED:
            self.stats.requests_completed += 1
            if ts is not None:
                ts.completed += 1
        elif status == FAILED:
            self.stats.aborted += 1
            if ts is not None:
                ts.aborted += 1
        elif status == EXPIRED:
            self.stats.expired += 1
            if ts is not None:
                ts.expired += 1
        elif status == CANCELLED:
            self.stats.cancelled += 1
            if ts is not None:
                ts.cancelled += 1

    def _expire_overdue(self) -> None:
        """Step-boundary deadline watchdog: EXPIRE every request (queued or
        running) whose ``deadline_ms`` has elapsed. Donor pins are zero at
        a step boundary, so the slot's prefix-index entries stay valid."""
        if not self._deadline:
            return
        now = self._clock_fn()
        for rid in [r for r, t in self._deadline.items() if now >= t]:
            r = self._req.get(rid)
            ms = None if r is None else r.deadline_ms
            self._finalize(rid, EXPIRED,
                           f"deadline_ms={ms} exceeded at step boundary")

    def _push_token(self, slot: int, logits_row: np.ndarray) -> None:
        rid = self._slot_req[slot]
        r = self._req[rid]
        tok = _sample_token(logits_row, r.sampling, self._slot_rng[slot])
        if r.stop_tokens and tok in r.stop_tokens:
            self._finalize(rid, FINISHED)
            return
        # the first token closes the TTFT window (submit -> first token);
        # later tokens feed the inter-token gap
        now = self._clock_fn()
        if not self._out[rid]:
            t0 = self._submit_t.get(rid)
            if t0 is not None:
                ttft = (now - t0) * 1e3
                self.stats.ttft_ms.observe(ttft)
                self.stats.tenant(r.tenant).ttft_ms.observe(ttft)
        else:
            tprev = self._last_tok_t.get(rid)
            if tprev is not None:
                self.stats.tok_ms.observe((now - tprev) * 1e3)
        self._last_tok_t[rid] = now
        self._out[rid].append(tok)
        self.stats.tokens_generated += 1
        self.stats.tenant(r.tenant).tokens += 1
        self._slot_last[slot] = tok
        self._slot_left[slot] -= 1
        if self._slot_left[slot] <= 0:
            self._finalize(rid, FINISHED)

    # -- admission --------------------------------------------------------------
    def _resolve_placement(self, rids: List[int],
                           match: Dict[int, Tuple[Optional[int], int]],
                           free: List[int]):
        """This round's slot placement under donor pins.

        The placement pool is the free slots with no pins. When pinned free
        donors starve it: a donor with a SINGLE consumer hosts that
        consumer itself (copy and overwrite happen in one launch); other
        consumers are DEFERRED to the next round (``put_front``: they
        re-match against the same resident donors); if the round would
        still fall short, matches are dropped — progress wins over reuse.

        Returns ``(keep, avail, self_place)``: the requests to admit, an
        ordered slot pool covering them, and per-request self-placement.
        Every remaining pin belongs to a kept request's match and is
        released right after the launch that consumes it."""
        n = len(rids)
        avail = [i for i in free if self._slot_refs[i] == 0]
        self_place: Dict[int, int] = {}
        if len(avail) >= n:
            return rids, avail, self_place
        keep = list(rids)
        deferred: List[int] = []
        for rid in reversed(rids):
            if len(avail) + len(self_place) >= len(keep):
                break
            donor, _ = match[rid]
            if donor is None or self._active[donor]:
                continue
            if self._slot_refs[donor] == 1:
                self_place[rid] = donor            # sole consumer: host it
                continue
            if len(keep) == 1:
                continue
            keep.remove(rid)
            deferred.append(rid)
            match.pop(rid)
            self._slot_refs[donor] -= 1
            if self._slot_refs[donor] == 0:
                avail.append(donor)
        if len(avail) + len(self_place) < len(keep):
            # still starved: give up matches (full prefill) so the round
            # still admits
            for rid in keep:
                donor, _ = match[rid]
                if donor is None or self._active[donor] \
                        or rid in self_place:
                    continue
                self._slot_refs[donor] -= 1
                match[rid] = (None, 0)
                if self._slot_refs[donor] == 0:
                    avail.append(donor)
                if len(avail) + len(self_place) >= len(keep):
                    break
        # deferred holds latest-taken first; pushing in that order leaves
        # the earliest-taken at the queue head
        for rid in deferred:
            self._sched.put_front(rid, self._req[rid].prompt_len,
                                  tenant=self._req[rid].tenant)
        return keep, avail, self_place

    def _on_launch(self, kind: str, index: int, rids) -> None:
        """Fault-injection hook; passes the sorted tenants riding in the
        launch to injectors that take them (``accepts_tenants``)."""
        if self.faults is None:
            return
        if getattr(self.faults, "accepts_tenants", False):
            tenants = tuple(sorted({self._req[rid].tenant for rid in rids
                                    if rid in self._req}))
            self.faults.on_launch(kind, index, tenants=tenants)
        else:
            self.faults.on_launch(kind, index)

    def _admit(self) -> None:
        free = [i for i in range(self.batch) if not self._active[i]]
        if not free:
            return
        # take from the queue, skipping stale entries (requests cancelled
        # or expired while queued stay in the heap until taken here)
        rids: List[int] = []
        while len(rids) < len(free) and len(self._sched):
            for rid in self._sched.take(len(free) - len(rids)):
                if rid in self._finished:
                    continue
                rids.append(rid)
        if not rids:
            return
        # match against the RESIDENT index (donors placed in earlier
        # rounds); a matched donor is pinned until its copy has run
        match: Dict[int, Tuple[Optional[int], int]] = {}
        for rid in rids:
            p = np.asarray(self._req[rid].prompt, np.int32).reshape(-1)
            donor, m = self._match_prefix(p)
            match[rid] = (donor, m)
            if donor is not None:
                self._slot_refs[donor] += 1
        rids, avail, self_place = self._resolve_placement(rids, match, free)
        if self.prefix_cache:
            # lookups count ADMITTED requests only (deferred ones re-match
            # next round)
            self.stats.prefix_lookups += len(rids)
        by_bucket: Dict[int, List[int]] = {}
        for rid in rids:
            tail = self._req[rid].prompt_len - match[rid][1]
            Sb = pick_bucket(tail, self.prompt_buckets)
            by_bucket.setdefault(Sb, []).append(rid)
        for Sb in sorted(by_bucket):
            rids_b = by_bucket[Sb]
            for Bb in batch_split(len(rids_b), self.batch_buckets):
                chunk, rids_b = rids_b[:Bb], rids_b[Bb:]
                self._launch_prefill(chunk, Bb, Sb, match, avail,
                                     self_place)

    def _launch_prefill(self, chunk, Bb, Sb, match, avail, self_place):
        """One bucket-shaped prefill launch for ``chunk``; a transient
        fault fails only this chunk's requests."""
        slots = []
        for rid in chunk:
            s = self_place.get(rid)
            if s is None:
                s = avail.pop(0)
            else:
                # the consumer's own pin; released before eviction so
                # _index_drop_slot sees an unreferenced slot
                self._slot_refs[s] -= 1
            slots.append(s)
        toks = np.zeros((Bb, Sb), np.int64)
        pos = np.zeros((Bb, Sb), np.int32)
        donor_idx = np.asarray(slots, np.int64)
        mlen = np.zeros(Bb, np.int32)
        prompts: List[np.ndarray] = []
        for j, rid in enumerate(chunk):
            p = np.asarray(self._req[rid].prompt, np.int32).reshape(-1)
            prompts.append(p)
            donor, m = match[rid]
            T = p.shape[0] - m
            toks[j, Sb - T:] = p[m:]
            if m > 0:
                # tail at positions m..m+T-1; pad writes park on ring slots
                # m+T..m+Sb-1 with NEGATIVE stored positions (masked),
                # clear of the copied donor rows [0, m)
                pos[j, Sb - T:] = m + np.arange(T, dtype=np.int32)
                pos[j, : Sb - T] = (m + T + np.arange(Sb - T, dtype=np.int32)
                                    - self.cache_len)
                donor_idx[j] = donor
                mlen[j] = m
                self.stats.prefix_hits += 1
                self.stats.prefill_tokens_saved += int(m)
            else:
                # pads get negative positions -> attention-masked
                pos[j] = np.arange(Sb, dtype=np.int32) - (Sb - T)
            self.stats.padded_prompt_tokens += Sb - T
        for slot in slots:
            self._index_drop_slot(slot)           # rows being overwritten
        kw = {}
        if self.prefix_cache:
            kw["donor_idx"] = self._tensor(donor_idx)
            kw["match_len"] = self._tensor(mlen)
        if self.runner.requires_extra:
            kw["extra"] = self._tensor(np.stack([
                np.asarray(self._req[rid].extra, np.float32)
                for rid in chunk]))
        try:
            self._on_launch("prefill", self.stats.prefill_calls, chunk)
            logits, ok, self.cache = self.runner.prefill(
                self._tensor(toks), self._tensor(pos), self.cache,
                self._tensor(np.asarray(slots, np.int64)), **kw)
        # lint: allow-broad-except — fault-isolation boundary:
        # classify_error decides request-fatal vs engine-fatal
        except BaseException as e:
            if classify_error(e) != "request":
                self._die(e)
            # transient fault BEFORE the launch: state intact, slot rows
            # untouched (still free, already out of the index). Release
            # this chunk's donor pins and FAIL only its requests.
            for rid in chunk:
                donor, _ = match[rid]
                if donor is not None and rid not in self_place:
                    self._slot_refs[donor] -= 1
                self._finalize(rid, FAILED, f"prefill launch failed: {e}")
            return
        # copies landed: release this chunk's donor pins (self-placed
        # consumers already released theirs)
        for rid in chunk:
            donor, _ = match[rid]
            if donor is not None and rid not in self_place:
                self._slot_refs[donor] -= 1
        self.stats.prefill_calls += 1
        self.stats.prefill_shapes.add((Bb, Sb))
        lg = logits.float().cpu().numpy()
        okh = ok.cpu().numpy()
        for j, (slot, rid) in enumerate(zip(slots, chunk)):
            if not okh[j]:
                # poisoned row: its NaN k/v already landed in the slot —
                # scrub back to blank rows and never index or activate it
                self._scrub_slot(slot)
                self._finalize(rid, FAILED,
                               "non-finite logits in prefill "
                               "(request aborted; batch continues)")
                continue
            r = self._req[rid]
            self.stats.tenant(r.tenant).admitted += 1
            self._index_insert(slot, prompts[j])
            self._slot_req[slot] = rid
            self._rid_slot[rid] = slot
            self._slot_rng[slot] = r.sampling.make_rng()
            self._slot_pos[slot] = r.prompt_len
            self._slot_left[slot] = r.max_new
            self._active[slot] = True
            self._push_token(slot, lg[j])

    # -- decode -----------------------------------------------------------------
    def _decode_step(self) -> None:
        act = np.nonzero(self._active)[0]
        n = act.size
        if n == 0:
            return
        Bb = pick_bucket(n, self.decode_buckets)
        # pad lanes borrow distinct free slot rows: the place-back has no
        # duplicate indices and pad writes land on dead rows. With the
        # prefix cache on, borrow non-donor rows first and evict (least
        # recently used first) any donor that must be borrowed — its rows
        # are about to take an unmasked pad write.
        idx = act
        if Bb > n:
            free = np.nonzero(~self._active)[0]
            if self.prefix_cache:
                plain = [int(i) for i in free
                         if self._slot_prompt[i] is None]
                donors = sorted((int(i) for i in free
                                 if self._slot_prompt[i] is not None),
                                key=lambda s: self._slot_touch[s])
                borrow = (plain + donors)[: Bb - n]
                for s in borrow:
                    self._index_drop_slot(s)
                idx = np.concatenate([act, np.asarray(borrow, act.dtype)])
            else:
                idx = np.concatenate([act, free[: Bb - n]])
        # ONE retry for a transient (pre-launch) fault: the injector fires
        # a scheduled fault once, so the retry runs the same launch on
        # intact state. A second failure, or any other error, is fatal.
        attempt = 0
        while True:
            try:
                self._on_launch("decode", self.stats.decode_steps,
                                [self._slot_req[int(s)] for s in act])
                logits, ok, self.cache = self.runner.decode(
                    self._tensor(self._slot_last[idx][:, None]), self.cache,
                    self._tensor(self._slot_pos[idx]), self._tensor(idx))
                break
            # lint: allow-broad-except — fault-isolation boundary:
            # classify_error decides retry vs engine-fatal
            except BaseException as e:
                if classify_error(e) != "request" or attempt >= 1:
                    self._die(e)
                attempt += 1
                self.stats.launch_retries += 1
        self.stats.decode_steps += 1
        self.stats.slot_steps_active += int(n)
        self.stats.decode_rows += int(Bb)
        self.stats.decode_shapes.add(int(Bb))
        self._slot_pos[act] += 1
        lg = logits[:n].float().cpu().numpy()
        okh = ok[:n].cpu().numpy()
        for j, slot in enumerate(act):
            slot = int(slot)
            if not okh[j]:
                # poisoned row: abort just this request, scrub its rows and
                # drop it from the prefix index; other rows continue
                self._finalize(self._slot_req[slot], FAILED,
                               "non-finite logits in decode "
                               "(request aborted; batch continues)",
                               scrub=True)
                continue
            self._push_token(slot, lg[j])

    def audit(self, raise_on_violation: bool = False):
        """Run every single-engine structural contract
        (``analysis.contracts.audit_engine``: each bucket's prefill and
        decode captured on prewarm's synthetic rows and a clone of the
        cache, and the frozen-table dtypes) and return the violations; an
        empty list is the pass condition. The engine's state, stats,
        prefix index and warm shapes are left as they were. With
        ``raise_on_violation=True`` a non-empty result raises
        :class:`~repro_torch.analysis.contracts.StructuralContractError`,
        whose message carries each violation's ``file:line``.
        ``audit_traces`` keeps the captures, ``(surface, capture)`` per
        bucket (none for a dense config), for launch counts."""
        from repro_torch.analysis.contracts import (StructuralContractError,
                                                    audit_engine,
                                                    serve_traces)

        self._check_alive()
        traces = serve_traces(self) if self.cfg.swm.enabled else []
        violations = audit_engine(self, traces)
        self.audit_traces = traces
        if raise_on_violation and violations:
            raise StructuralContractError(violations)
        return violations

    def prewarm(self, audit: bool = False) -> int:
        """Launch every (batch-bucket, prompt-bucket) prefill shape and
        every decode-bucket shape once, so steady-state serving launches
        no shape it has not run. Returns ``prefill_compiles +
        decode_compiles``.

        The state is written in place, so every warm-up write is masked:
        all-pad prefill rows (every position negative) into slots
        ``0..Bb-1``, each its own donor at match 0 with the prefix cache,
        and decode probes at position -1, whose ring write lands with a
        negative stored position. Admission replaces a slot's rows whole
        (fresh or masked-seeded), so the tokens served afterwards are the
        cold engine's. The writes touch free slot rows: prewarm needs an
        IDLE engine (no active slots) and flushes the prefix index first
        (spilling to the store, when one is attached). Warm-up launches
        are not counted in ``stats`` and reach no fault injector.
        ``audit=True`` runs :meth:`audit` first and raises on any
        violation before a single warm-up launch."""
        self._check_alive()
        if self._active.any():
            raise RuntimeError(
                "prewarm() requires an idle engine: warm-up launches commit "
                "(masked) writes into slot rows that active requests own")
        if audit:
            self.audit(raise_on_violation=True)
        if self.prefix_cache:
            for s in range(self.batch):
                self._index_drop_slot(s)
        for Sb in self.prompt_buckets:
            for Bb in self.batch_buckets:
                # all-pad rows: fully masked, shape-identical to traffic
                pos = np.repeat((np.arange(Sb, dtype=np.int32) - Sb)[None],
                                Bb, axis=0)
                slots = self._tensor(np.arange(Bb, dtype=np.int64))
                kw = {}
                if self.prefix_cache:
                    kw["donor_idx"] = slots
                    kw["match_len"] = self._tensor(np.zeros(Bb, np.int32))
                ex = self.runner.prewarm_extra(Bb)
                if ex is not None:
                    kw["extra"] = ex
                _, _, self.cache = self.runner.prefill(
                    self._tensor(np.zeros((Bb, Sb), np.int64)),
                    self._tensor(pos), self.cache, slots, **kw)
                self._warm_prefill.add((Bb, Sb))
        for Bb in self.decode_buckets:
            _, _, self.cache = self.runner.decode(
                self._tensor(np.zeros((Bb, 1), np.int64)), self.cache,
                self._tensor(np.full(Bb, -1, np.int64)),
                self._tensor(np.arange(Bb, dtype=np.int64)))
            self._warm_decode.add(Bb)
        return self.prefill_compiles + self.decode_compiles

    # -- public API ---------------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Enqueue one request; returns its request id. With ``max_queue``
        set, a submit at the bound raises :class:`QueueFullError`
        (``reject``: nothing enqueued, ``stats.rejected`` counts it) or
        sheds the longest-queued request as CANCELLED (``drop-oldest``).
        The deadline clock starts now."""
        self._check_alive()
        self._validate(request)
        if self._sched.max_queue is not None:
            # stale entries (cancelled/expired while queued) must not count
            # against the bound
            self._sched.purge(lambda rid: rid not in self._finished)
        rid = self._next_rid
        try:
            dropped = self._sched.submit(rid, request.prompt_len,
                                         tenant=request.tenant)
        except QueueFullError:
            self.stats.rejected += 1
            self.stats.tenant(request.tenant).rejected += 1
            raise
        self._next_rid += 1
        self._req[rid] = request
        self._out[rid] = []
        self._submit_t[rid] = self._clock_fn()
        self.stats.tenant(request.tenant).submitted += 1
        if request.deadline_ms is not None:
            self._deadline[rid] = (self._clock_fn()
                                   + request.deadline_ms / 1000.0)
        if dropped is not None:
            self.stats.rejected += 1
            self._finalize(dropped, CANCELLED,
                           "load shed (drop-oldest): queue at max_queue="
                           f"{self._sched.max_queue}")
        return rid

    def cancel(self, req_id: int) -> bool:
        """Cancel a queued or running request: its slot (if any) is
        recycled and its partial tokens stay claimable via ``drain``.
        Returns True if this call cancelled it, False if it was already
        terminal; raises ``KeyError`` for unknown or claimed ids."""
        if req_id in self._finished:
            return False
        if req_id not in self._out:
            raise KeyError(f"unknown or already-claimed request id {req_id}")
        self._finalize(req_id, CANCELLED, "cancelled by caller")
        return True

    def step(self) -> bool:
        """Expire overdue deadlines, admit queued requests into free slots
        (bucketed prefill), then run one compacted decode step;
        auto-snapshot every ``snapshot_every`` steps. True while work
        remains. Raises :class:`EngineFatalError` (and marks the engine
        dead) on an unrecoverable launch error."""
        self._check_alive()
        t0 = self._clock_fn()
        if self.faults is not None:
            self.faults.on_step(self._step_count)
        self._expire_overdue()
        self._admit()
        self._decode_step()
        self._step_count += 1
        now = self._clock_fn()
        self._observe_drain(now)
        if self._watchdog.observe(self._step_count, now - t0) != "ok":
            self.stats.slow_steps += 1
        # auto-snapshot skips an EMPTY engine (no queued, running or
        # unclaimed requests): restoring such a snapshot is refused, and
        # idle-loop callers would overwrite the last useful one
        if (self.snapshot_dir is not None and self.snapshot_every > 0
                and self._step_count % self.snapshot_every == 0
                and (self._req or self._finished)):
            self.snapshot()
        return bool(self._active.any() or len(self._sched))

    def poll(self, req_id: int) -> RequestState:
        """Progress of a submitted request, without consuming it: tokens so
        far, lifecycle ``status`` and the ``error`` of failed terminals."""
        if req_id in self._finished:
            return RequestState(req_id, True, tuple(self._finished[req_id]),
                                self._status.get(req_id, FINISHED),
                                self._error.get(req_id))
        if req_id in self._out:
            status = RUNNING if req_id in self._rid_slot else QUEUED
            return RequestState(req_id, False, tuple(self._out[req_id]),
                                status, None)
        raise KeyError(f"unknown or already-claimed request id {req_id}")

    def drain(self, req_ids: Optional[Sequence[int]] = None
              ) -> Dict[int, List[int]]:
        """Step until idle, then claim terminal outputs (default: all) —
        partial tokens for FAILED/EXPIRED/CANCELLED terminals."""
        while self.step():
            pass
        rids = list(self._finished) if req_ids is None else list(req_ids)
        if len(set(rids)) != len(rids):
            raise KeyError(f"duplicate request ids in drain: {rids}")
        for rid in rids:
            if rid not in self._finished:
                raise KeyError(
                    f"request id {rid} is not a finished unclaimed request")
        out = {}
        for rid in rids:
            out[rid] = self._finished.pop(rid)
            self._status.pop(rid, None)
            self._error.pop(rid, None)
        return out

    def generate(self, requests: List[Request]) -> List[List[int]]:
        """Serve a list of requests; per-request tokens in request order.
        A submit rejected at the ``max_queue`` bound steps the engine and
        retries."""
        for r in requests:
            self._validate(r)
        rids = []
        for r in requests:
            while True:
                try:
                    rids.append(self.submit(r))
                    break
                except QueueFullError:
                    self.step()
        done = self.drain(rids)
        return [done[rid] for rid in rids]

    # -- snapshot / restore ---------------------------------------------------
    _STAT_FIELDS = (
        "prefill_calls", "decode_steps", "tokens_generated",
        "requests_completed", "padded_prompt_tokens", "slot_steps_active",
        "decode_rows", "prefix_lookups", "prefix_hits",
        "prefill_tokens_saved", "rejected", "aborted", "expired",
        "cancelled", "recoveries", "snapshots", "launch_retries",
        "slow_steps", "prefix_spills", "prefix_adoptions",
    )

    def _fingerprint(self) -> Dict[str, object]:
        """Configuration identity a snapshot is only valid against."""
        return {
            "batch": self.batch, "cache_len": self.cache_len,
            "runner": type(self.runner).__name__,
            "policy": self.policy,
            "prompt_buckets": list(self.prompt_buckets),
            "decode_buckets": list(self.decode_buckets),
            "prefix_cache": self.prefix_cache,
            "prefix_block": self.prefix_block,
            "prefix_capacity": self.prefix_capacity,
            "vocab": int(self.cfg.vocab),
            "max_queue": self.max_queue,
            "shed_policy": self.shed_policy,
            "quantize": self.quantize,
            "tenant_weights": [[k, int(v)] for k, v in
                               sorted(self.tenant_weights.items())],
        }

    def snapshot(self) -> str:
        """Write the whole serving state — slot state, slot table,
        scheduler queue, per-request outputs and RNG states, prefix index,
        deadlines (as remaining budget), submit and last-token times (as
        ages), counters and histograms — as one atomic checkpoint step
        (format version 3) under ``snapshot_dir``. A replacement engine
        with the same configuration ``restore()``s it and resumes every
        decode mid-stream. Returns the checkpoint path.

        Runs at step boundaries only, where donor pins are zero."""
        self._check_alive()
        if self.snapshot_dir is None:
            raise ValueError("snapshot() needs snapshot_dir")
        assert (self._slot_refs == 0).all(), \
            "snapshot mid-admission: donor rows are pinned"
        now = self._clock_fn()
        extra_rids = sorted(rid for rid, r in self._req.items()
                            if r.extra is not None)
        meta = {
            "version": 3,
            "fingerprint": self._fingerprint(),
            "step_count": self._step_count,
            "next_rid": self._next_rid,
            "prefix_clock": self._clock,
            "extra_rids": extra_rids,
            "requests": [
                [rid, {
                    "prompt": np.asarray(r.prompt, np.int32)
                    .reshape(-1).tolist(),
                    "max_new": int(r.max_new),
                    "stop_tokens": list(r.stop_tokens),
                    "sampling": {
                        "temperature": float(r.sampling.temperature),
                        "top_k": int(r.sampling.top_k),
                        "seed": int(r.sampling.seed)},
                    "deadline_ms": r.deadline_ms,
                    "tenant": r.tenant,
                }] for rid, r in self._req.items()],
            "out": [[rid, list(t)] for rid, t in self._out.items()],
            "finished": [[rid, list(t), self._status.get(rid, FINISHED),
                          self._error.get(rid)]
                         for rid, t in self._finished.items()],
            "deadline_remaining_s": [[rid, max(0.0, t - now)]
                                     for rid, t in self._deadline.items()],
            # submit and last-token times as AGES: absolute clocks do not
            # survive process boundaries, relative ones do
            "timing": {
                "submit_age_s": [[rid, now - t]
                                 for rid, t in self._submit_t.items()],
                "last_tok_age_s": [[rid, now - t]
                                   for rid, t in self._last_tok_t.items()],
            },
            "sched": self._sched.state_dict(),
            "rid_slot": [[rid, int(s)] for rid, s in self._rid_slot.items()],
            "slots": {
                "active": [bool(x) for x in self._active],
                "req": [None if x is None else int(x)
                        for x in self._slot_req],
                "pos": [int(x) for x in self._slot_pos],
                "last": [int(x) for x in self._slot_last],
                "left": [int(x) for x in self._slot_left],
                "touch": [int(x) for x in self._slot_touch],
                "prompt": [None if p is None else p.tolist()
                           for p in self._slot_prompt],
                "rng": [None if g is None else g.bit_generator.state
                        for g in self._slot_rng],
            },
            "prefix_index": [[int(m), raw.hex(), int(slot)]
                             for (m, raw), slot in
                             self._prefix_index.items()],
            "stats": {f: int(getattr(self.stats, f))
                      for f in self._STAT_FIELDS},
            "stats_shapes": {
                "prefill": sorted([int(b), int(s)]
                                  for b, s in self.stats.prefill_shapes),
                "decode": sorted(int(b)
                                 for b in self.stats.decode_shapes)},
            # fixed-bucket histograms serialize exactly: restore resumes
            # the same p50/p99
            "stats_hists": {
                "ttft": list(self.stats.ttft_ms.counts),
                "tok": list(self.stats.tok_ms.counts)},
            "stats_tenants": [
                [t, {"submitted": ts.submitted, "admitted": ts.admitted,
                     "completed": ts.completed, "rejected": ts.rejected,
                     "expired": ts.expired, "cancelled": ts.cancelled,
                     "aborted": ts.aborted, "tokens": ts.tokens,
                     "ttft": list(ts.ttft_ms.counts)}]
                for t, ts in sorted(self.stats.tenants.items())],
        }
        # the state tree is written opaquely, in canonical flat leaf order
        state = {
            "cache": flatten_state_tree(self.cache),
            "meta": np.frombuffer(json.dumps(meta).encode("utf-8"),
                                  np.uint8),
        }
        if extra_rids:
            # per-request conditioning (enc-dec encoder frames) rides in
            # the array section; meta["extra_rids"] names the owners
            state["extra"] = {
                f"r{rid:08d}": np.asarray(self._req[rid].extra, np.float32)
                for rid in extra_rids}
        path = save_checkpoint(self.snapshot_dir, self._step_count, state)
        self.stats.snapshots += 1
        return path

    def restore(self, step: Optional[int] = None) -> int:
        """Load a snapshot into THIS engine (fresh and idle: the
        replacement for a dead one, built with the same configuration) and
        resume where the snapshot left off; the latest snapshot in
        ``snapshot_dir`` by default. Deadlines resume with the budget they
        had left. Returns the restored step count; ``stats.recoveries``
        counts successful restores. No snapshot in ``snapshot_dir`` raises
        ``FileNotFoundError``; a step this engine refuses (another version
        or configuration, empty, or a meta that does not parse) raises
        ``ValueError``, so a caller can walk back to an older step."""
        self._check_alive()
        if self.snapshot_dir is None:
            raise ValueError("restore() needs snapshot_dir")
        if self._active.any() or len(self._sched) or self._req \
                or self._finished:
            raise RuntimeError(
                "restore() needs a fresh idle engine (no queued, active, "
                "or unclaimed requests): build a replacement engine with "
                "the same configuration and restore into that")
        if step is None:
            step = ckpt_latest_step(self.snapshot_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no snapshot found in {self.snapshot_dir}")
        state = restore_checkpoint(self.snapshot_dir, int(step),
                                   device="cpu")
        try:
            meta = json.loads(state["meta"].numpy().tobytes()
                              .decode("utf-8"))
            if not isinstance(meta, dict):
                raise TypeError(f"meta is a {type(meta).__name__}")
        except (KeyError, TypeError, ValueError) as e:
            # ValueError is the refusal a caller walks past (the
            # supervisor tries the next older snapshot)
            raise ValueError(
                f"snapshot at step {step} is not a serving snapshot: its "
                f"meta does not parse ({type(e).__name__}: {e})") from e
        if int(meta.get("version", 0)) != 3:
            raise ValueError(
                f"snapshot at step {step} has format version "
                f"{meta.get('version')!r}; this build reads version 3 "
                f"(tenant-aware scheduler + latency histograms) — "
                f"re-snapshot with the current build")
        fp = self._fingerprint()
        if meta["fingerprint"] != fp:
            raise ValueError(
                f"snapshot fingerprint mismatch: saved "
                f"{meta['fingerprint']} vs this engine {fp} — restore "
                f"needs an identically-configured engine")
        if not meta["requests"] and not meta["finished"]:
            raise ValueError(
                f"snapshot at step {step} is EMPTY (no queued, running, "
                f"or unclaimed requests) — restoring it would resume "
                f"nothing. Snapshot after work is submitted, or restore "
                f"an earlier non-empty step explicitly")
        # rebuild the opaque state tree against the runner's template
        # (structure, dtype and device); a leaf-count mismatch raises
        self.cache = unflatten_state_tree(
            self.runner.init_state(self.batch), state["cache"])
        self._step_count = int(meta["step_count"])
        self._next_rid = int(meta["next_rid"])
        self._clock = int(meta["prefix_clock"])
        self._req = {
            int(rid): Request(
                prompt=np.asarray(d["prompt"], np.int32),
                max_new=int(d["max_new"]),
                stop_tokens=tuple(d["stop_tokens"]),
                sampling=SamplingParams(
                    temperature=float(d["sampling"]["temperature"]),
                    top_k=int(d["sampling"]["top_k"]),
                    seed=int(d["sampling"]["seed"])),
                deadline_ms=d["deadline_ms"],
                tenant=d.get("tenant", "default"),
            ) for rid, d in meta["requests"]}
        for rid in meta.get("extra_rids", []):
            self._req[int(rid)].extra = \
                state["extra"][f"r{int(rid):08d}"].numpy()
        self._out = {int(rid): [int(t) for t in toks]
                     for rid, toks in meta["out"]}
        self._finished, self._status, self._error = {}, {}, {}
        for rid, toks, status, err in meta["finished"]:
            self._finished[int(rid)] = [int(t) for t in toks]
            self._status[int(rid)] = status
            self._error[int(rid)] = err
        now = self._clock_fn()
        self._deadline = {int(rid): now + float(rem)
                          for rid, rem in meta["deadline_remaining_s"]}
        tm = meta["timing"]
        self._submit_t = {int(rid): now - float(age)
                          for rid, age in tm["submit_age_s"]}
        self._last_tok_t = {int(rid): now - float(age)
                            for rid, age in tm["last_tok_age_s"]}
        self._sched = self._new_scheduler()
        self._sched.load_state(meta["sched"])
        self._rid_slot = {int(rid): int(s) for rid, s in meta["rid_slot"]}
        sl = meta["slots"]
        self._active = np.asarray(sl["active"], bool)
        self._slot_req = [None if x is None else int(x) for x in sl["req"]]
        self._slot_pos = np.asarray(sl["pos"], np.int64)
        self._slot_last = np.asarray(sl["last"], np.int64)
        self._slot_left = np.asarray(sl["left"], np.int64)
        self._slot_touch = np.asarray(sl["touch"], np.int64)
        self._slot_prompt = [None if p is None else np.asarray(p, np.int32)
                             for p in sl["prompt"]]
        self._slot_rng = []
        for st in sl["rng"]:
            if st is None:
                self._slot_rng.append(None)
            else:
                g = np.random.default_rng(0)
                g.bit_generator.state = st
                self._slot_rng.append(g)
        self._slot_refs = np.zeros(self.batch, np.int64)
        self._prefix_index = OrderedDict(
            ((int(m), bytes.fromhex(raw)), int(slot))
            for m, raw, slot in meta["prefix_index"])
        st = meta["stats"]
        for f in self._STAT_FIELDS:
            setattr(self.stats, f, int(st.get(f, 0)))
        self.stats.prefill_shapes = {
            (int(b), int(s)) for b, s in meta["stats_shapes"]["prefill"]}
        self.stats.decode_shapes = {
            int(b) for b in meta["stats_shapes"]["decode"]}
        hists = meta["stats_hists"]
        self.stats.ttft_ms = LatencyHistogram(hists["ttft"])
        self.stats.tok_ms = LatencyHistogram(hists["tok"])
        self.stats.tenants = {}
        for t, d in meta["stats_tenants"]:
            ts = self.stats.tenant(t)
            ts.submitted = int(d["submitted"])
            ts.admitted = int(d["admitted"])
            ts.completed = int(d["completed"])
            ts.rejected = int(d["rejected"])
            ts.expired = int(d["expired"])
            ts.cancelled = int(d["cancelled"])
            ts.aborted = int(d["aborted"])
            ts.tokens = int(d["tokens"])
            ts.ttft_ms = LatencyHistogram(d["ttft"])
        self.stats.recoveries += 1
        return int(step)


# ---------------------------------------------------------------------------
# The wave baseline
# ---------------------------------------------------------------------------


class WaveEngine:
    """Fixed-wave batching baseline: requests are served in waves of
    ``batch``; every wave left-pads to its longest prompt (one launch shape
    per distinct wave length) and every slot stalls until the wave's
    largest ``max_new`` finishes. Greedy only.

    The comparison point for :class:`ServeEngine`: it shares the negative
    pad positions, so its greedy tokens equal the continuous engine's
    wherever the two launch the same arithmetic. ``params`` is frozen
    (``quantize``) and installed in ``model`` as the continuous engine
    does; each wave allocates a fresh cache on ``model.device``.
    """

    def __init__(self, model, cfg: ModelConfig, params, batch: int,
                 cache_len: int, *, quantize: str = "off"):
        if cfg.family == "encdec":
            raise ValueError(
                "WaveEngine is a decoder-LM baseline: enc-dec serving "
                "needs a per-request encoder pass — use ServeEngine, "
                "which serves encdec configs through EncDecRunner")
        mix = recurrent_mixer_names(cfg)
        if int(batch) > 1 and mix:
            # a wave of one never pads; larger waves pad to the wave max
            raise ValueError(
                f"wave prefill left-pads prompts, and the wave baseline "
                f"gives {'/'.join(mix)} layers no pad-validity guarantee "
                f"for their recurrent state — serve this family with "
                f"ServeEngine (pad-aware bucketed prefill) or batch=1 "
                f"waves (never padded)")
        _check_quantize(quantize)
        if quantize != "off" and not cfg.swm.enabled:
            raise ValueError(
                "quantize applies to frozen circulant tables; this config "
                "has swm disabled")
        if cfg.swm.enabled:
            params = freeze_params(model.specs(), params, quantize=quantize)
        load_tree(model, params)
        self.device = model.device
        self.quantize = quantize
        self.model, self.cfg, self.params = model, cfg, params
        self.batch, self.cache_len = int(batch), int(cache_len)
        self.stats = EngineStats()
        self._prefill = make_prefill_step(model, cfg)
        self._decode = make_decode_step(model, cfg)

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill launch shapes so far (one per wave length)."""
        return len(self.stats.prefill_shapes)

    @property
    def decode_compiles(self) -> int:
        """Distinct decode launch shapes so far."""
        return len(self.stats.decode_shapes)

    def frozen_table_bytes(self) -> int:
        """Resident bytes of the frozen frequency tables (scales
        included)."""
        return frozen_table_bytes(self.params)

    def generate(self, requests: List[Request]) -> List[List[int]]:
        """Greedy-decode a list of requests in fixed batched waves."""
        for r in requests:
            _validate_request(r, self.cache_len)
            if r.sampling.temperature > 0 or r.stop_tokens:
                raise ValueError(
                    "WaveEngine is a greedy-only baseline: per-request "
                    "sampling and stop tokens need ServeEngine")
            if r.deadline_ms is not None:
                raise ValueError(
                    "WaveEngine has no request lifecycle: deadlines, "
                    "cancellation, and load shedding need ServeEngine")
        results: List[List[int]] = []
        for i in range(0, len(requests), self.batch):
            results.extend(self._run_wave(requests[i: i + self.batch]))
        return results

    def _run_wave(self, wave: List[Request]) -> List[List[int]]:
        B = self.batch
        plen = max(r.prompt_len for r in wave)
        toks = np.zeros((B, plen), np.int64)
        pos = np.zeros((B, plen), np.int32)
        lens = np.zeros(B, np.int64)
        for j in range(B):
            L = wave[j].prompt_len if j < len(wave) else 0
            lens[j] = L
            if L:
                toks[j, plen - L:] = np.asarray(
                    wave[j].prompt, np.int32).reshape(-1)
            pos[j] = np.arange(plen, dtype=np.int32) - (plen - L)
        cache = self.model.init_cache(B, self.cache_len)
        dev = self.device
        logits, cache = self._prefill(torch.as_tensor(toks, device=dev),
                                      cache, None,
                                      torch.as_tensor(pos, device=dev))
        self.stats.prefill_calls += 1
        self.stats.prefill_shapes.add((B, plen))
        outs: List[List[int]] = [[] for _ in wave]
        cur = np.argmax(logits.float().cpu().numpy(), axis=-1)
        for j, r in enumerate(wave):
            outs[j].append(int(cur[j]))
            self.stats.tokens_generated += 1
        max_new = max(r.max_new for r in wave)
        for t in range(max_new - 1):
            logits, cache = self._decode(
                torch.as_tensor(cur[:, None], device=dev), cache,
                torch.as_tensor(lens + t, device=dev))
            self.stats.decode_steps += 1
            self.stats.slot_steps_active += sum(
                1 for r in wave if t + 1 < r.max_new)
            self.stats.decode_rows += B
            self.stats.decode_shapes.add(B)
            cur = np.argmax(logits.float().cpu().numpy(), axis=-1)
            for j, r in enumerate(wave):
                if t + 1 < r.max_new:
                    outs[j].append(int(cur[j]))
                    self.stats.tokens_generated += 1
        for _ in wave:
            self.stats.requests_completed += 1
        return outs
