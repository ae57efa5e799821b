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
  the distinct shapes launched, the quantities a CUDA graph per bucket
  would capture.
* **Continuous batching, streamed** — requests occupy independent cache
  slots; a finished slot admits the next queued request immediately.
  Admission order is a :class:`Scheduler` policy (fifo or sjf); each
  request carries its own :class:`SamplingParams` and stop tokens.
  ``submit`` / ``step`` / ``poll`` / ``drain`` serve an open-ended stream;
  ``generate(list)`` is a thin wrapper over that loop.

Padding: bucketed prefill left-pads prompts and numbers the pad positions
negatively, so attention masks them (and recurrent mixers skip them) and
greedy outputs are the same at every bucket shape. Decode compaction is a
pure permutation of slot rows, over every state leaf the runner holds (KV
caches, Mamba's conv and SSM states, RWKV's shift and WKV states).

Everything model-shaped sits behind a :mod:`repro_torch.serve.runner`
runner. Requests of a family whose runner ``requires_extra`` (the enc-dec
family) carry their conditioning as ``Request.extra``, the encoder frames
``(enc_seq, d_model)``: the runner's ``validate_request`` checks it at
``submit``/``generate`` (decoder families refuse it), and a prefill
chunk's frames go to the runner stacked as f32. The reference engine's
prefix cache, deadlines/cancel/shedding, snapshot/restore, tenants and
audit are not ported yet; without its per-request NaN guard, non-finite
logits raise ``FloatingPointError``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.block_circulant.plan import (_check_quantize,
                                                      freeze_params,
                                                      frozen_table_bytes)
from repro_torch.nn.module import load_tree
from repro_torch.serve.runner import make_runner

__all__ = ["SamplingParams", "Request", "RequestState", "Scheduler",
           "EngineStats", "ServeEngine", "pow2_buckets", "pick_bucket",
           "batch_split", "validate_buckets", "QUEUED", "RUNNING",
           "FINISHED"]

QUEUED, RUNNING, FINISHED = "QUEUED", "RUNNING", "FINISHED"


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
    """``extra``: per-request conditioning for families whose runner
    declares ``requires_extra`` — for enc-dec configs, the encoder frame
    embeddings with shape ``(enc_seq, d_model)``. Decoder-only families
    must leave it ``None`` (the runner's ``validate_request`` enforces
    both ways)."""

    prompt: np.ndarray
    max_new: int = 16
    stop_tokens: Tuple[int, ...] = ()
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    extra: Optional[np.ndarray] = None

    def __post_init__(self):
        self.stop_tokens = tuple(int(t) for t in self.stop_tokens)

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).reshape(-1).shape[0])


@dataclasses.dataclass(frozen=True)
class RequestState:
    """``poll`` snapshot: tokens so far, terminal flag and status."""

    req_id: int
    done: bool
    tokens: Tuple[int, ...]
    status: str = QUEUED


def _validate_request(r: Request, cache_len: int) -> None:
    """Admission contract: no silent truncation, no zero budgets."""
    L = r.prompt_len
    if L == 0:
        raise ValueError("empty prompt")
    if r.max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {r.max_new}")
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
    """Admission queue: ``fifo`` or ``sjf`` (shortest-prompt-first).
    Per-request outputs are identical under every policy — slots are
    independent — only the admission order changes."""

    POLICIES = ("fifo", "sjf")

    def __init__(self, policy: str = "fifo"):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown scheduler policy {policy!r}; one of {self.POLICIES}")
        self.policy = policy
        self._heap: list = []             # (key, seq, item)
        self._seq = 0

    def submit(self, item, prompt_len: int) -> None:
        key = prompt_len if self.policy == "sjf" else 0
        heapq.heappush(self._heap, (key, self._seq, item))
        self._seq += 1

    def take(self, n: int) -> list:
        out = []
        while self._heap and len(out) < n:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def __len__(self) -> int:
        return len(self._heap)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------


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
    prefill_shapes: Set[Tuple[int, int]] = dataclasses.field(
        default_factory=set)
    decode_shapes: Set[int] = dataclasses.field(default_factory=set)

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


# ---------------------------------------------------------------------------
# The continuous-batching engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """Continuous batching over ``batch`` cache slots with bucketed shapes.

    ``params`` is the model's param tree (``model.specs()`` layout). The
    engine freezes it (``quantize`` "off" or "int8") and installs the
    frozen tree in ``model`` — one engine per model. Caches live on
    ``model.device``.
    """

    def __init__(self, model, cfg: ModelConfig, params, batch: int,
                 cache_len: int, *,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 decode_buckets: Optional[Sequence[int]] = None,
                 policy: str = "fifo", quantize: str = "off"):
        Scheduler(policy)              # fail fast on an unknown policy
        _check_quantize(quantize)
        if quantize != "off" and not cfg.swm.enabled:
            raise ValueError(
                "quantize applies to frozen circulant tables; this config "
                "has swm disabled")
        self.batch, self.cache_len = int(batch), int(cache_len)
        self.runner = make_runner(model, cfg, self.cache_len)
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
        self._sched = Scheduler(policy)
        self._next_rid = 0
        self._req: Dict[int, Request] = {}
        self._out: Dict[int, List[int]] = {}
        self._finished: Dict[int, List[int]] = {}
        self._rid_slot: Dict[int, int] = {}
        B = self.batch
        self.cache = self.runner.init_state(B)
        self._active = np.zeros(B, bool)
        self._slot_req: List[Optional[int]] = [None] * B
        self._slot_rng: List[Optional[np.random.Generator]] = [None] * B
        self._slot_pos = np.zeros(B, np.int64)
        self._slot_last = np.zeros(B, np.int64)
        self._slot_left = np.zeros(B, np.int64)

    # -- launch-shape accounting --------------------------------------------
    @property
    def max_prefill_variants(self) -> int:
        return len(self.batch_buckets) * len(self.prompt_buckets)

    @property
    def max_decode_variants(self) -> int:
        return len(self.decode_buckets)

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill launch shapes so far."""
        return len(self.stats.prefill_shapes)

    @property
    def decode_compiles(self) -> int:
        """Distinct decode launch shapes so far."""
        return len(self.stats.decode_shapes)

    def frozen_table_bytes(self) -> int:
        """Resident bytes of the frozen frequency tables (fused copies and
        int8 scales included)."""
        return frozen_table_bytes(self.params)

    # -- host-side request state ---------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _finalize(self, rid: int) -> None:
        slot = self._rid_slot.pop(rid, None)
        if slot is not None:
            self._active[slot] = False
            self._slot_req[slot] = None
            self._slot_rng[slot] = None
        self._req.pop(rid, None)
        self._finished[rid] = self._out.pop(rid, [])
        self.stats.requests_completed += 1

    def _push_token(self, slot: int, logits_row: np.ndarray) -> None:
        rid = self._slot_req[slot]
        r = self._req[rid]
        tok = _sample_token(logits_row, r.sampling, self._slot_rng[slot])
        if r.stop_tokens and tok in r.stop_tokens:
            self._finalize(rid)
            return
        self._out[rid].append(tok)
        self.stats.tokens_generated += 1
        self._slot_last[slot] = tok
        self._slot_left[slot] -= 1
        if self._slot_left[slot] <= 0:
            self._finalize(rid)

    # -- admission ------------------------------------------------------------
    def _admit(self) -> None:
        free = [i for i in range(self.batch) if not self._active[i]]
        if not free:
            return
        rids = self._sched.take(len(free))
        if not rids:
            return
        by_bucket: Dict[int, List[int]] = {}
        for rid in rids:
            Sb = pick_bucket(self._req[rid].prompt_len, self.prompt_buckets)
            by_bucket.setdefault(Sb, []).append(rid)
        for Sb in sorted(by_bucket):
            rids_b = by_bucket[Sb]
            for Bb in batch_split(len(rids_b), self.batch_buckets):
                chunk, rids_b = rids_b[:Bb], rids_b[Bb:]
                slots = [free.pop(0) for _ in chunk]
                toks = np.zeros((Bb, Sb), np.int64)
                pos = np.zeros((Bb, Sb), np.int32)
                for j, rid in enumerate(chunk):
                    p = np.asarray(self._req[rid].prompt,
                                   np.int64).reshape(-1)
                    T = p.shape[0]
                    toks[j, Sb - T:] = p
                    # pads get negative positions -> attention-masked
                    pos[j] = np.arange(Sb, dtype=np.int32) - (Sb - T)
                    self.stats.padded_prompt_tokens += Sb - T
                extra = None
                if self.runner.requires_extra:
                    extra = self._tensor(np.stack([
                        np.asarray(self._req[rid].extra, np.float32)
                        for rid in chunk]))
                logits, ok, self.cache = self.runner.prefill(
                    self._tensor(toks), self._tensor(pos), self.cache,
                    self._tensor(np.asarray(slots, np.int64)), extra=extra)
                self.stats.prefill_calls += 1
                self.stats.prefill_shapes.add((Bb, Sb))
                lg = logits.float().cpu().numpy()
                if not bool(ok.all()):
                    raise FloatingPointError("non-finite logits in prefill")
                for j, (slot, rid) in enumerate(zip(slots, chunk)):
                    r = self._req[rid]
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
        # duplicate indices and pad writes land on dead rows that the next
        # admission's prefill overwrites
        idx = act
        if Bb > n:
            free = np.nonzero(~self._active)[0]
            idx = np.concatenate([act, free[: Bb - n]])
        logits, ok, self.cache = self.runner.decode(
            self._tensor(self._slot_last[idx][:, None]), self.cache,
            self._tensor(self._slot_pos[idx]), self._tensor(idx))
        self.stats.decode_steps += 1
        self.stats.slot_steps_active += int(n)
        self.stats.decode_rows += int(Bb)
        self.stats.decode_shapes.add(int(Bb))
        self._slot_pos[act] += 1
        lg = logits[:n].float().cpu().numpy()
        if not bool(ok[:n].all()):
            raise FloatingPointError("non-finite logits in decode")
        for j, slot in enumerate(act):
            self._push_token(int(slot), lg[j])

    # -- public API ---------------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Enqueue one request; returns its request id."""
        _validate_request(request, self.cache_len)
        self.runner.validate_request(request)
        rid = self._next_rid
        self._next_rid += 1
        self._sched.submit(rid, request.prompt_len)
        self._req[rid] = request
        self._out[rid] = []
        return rid

    def step(self) -> bool:
        """Admit queued requests into free slots (bucketed prefill), then
        run one compacted decode step. True while work remains."""
        self._admit()
        self._decode_step()
        return bool(self._active.any() or len(self._sched))

    def poll(self, req_id: int) -> RequestState:
        """Progress of a submitted request, without consuming it."""
        if req_id in self._finished:
            return RequestState(req_id, True, tuple(self._finished[req_id]),
                                FINISHED)
        if req_id in self._out:
            status = RUNNING if req_id in self._rid_slot else QUEUED
            return RequestState(req_id, False, tuple(self._out[req_id]),
                                status)
        raise KeyError(f"unknown or already-claimed request id {req_id}")

    def drain(self, req_ids: Optional[Sequence[int]] = None
              ) -> Dict[int, List[int]]:
        """Step until idle, then claim finished outputs (default: all)."""
        while self.step():
            pass
        rids = list(self._finished) if req_ids is None else list(req_ids)
        if len(set(rids)) != len(rids):
            raise KeyError(f"duplicate request ids in drain: {rids}")
        for rid in rids:
            if rid not in self._finished:
                raise KeyError(
                    f"request id {rid} is not a finished unclaimed request")
        return {rid: self._finished.pop(rid) for rid in rids}

    def generate(self, requests: List[Request]) -> List[List[int]]:
        """Serve a list of requests; per-request tokens in request order."""
        for r in requests:
            _validate_request(r, self.cache_len)
            self.runner.validate_request(r)
        rids = [self.submit(r) for r in requests]
        done = self.drain(rids)
        return [done[rid] for rid in rids]
