"""Host-memory prefix store: evicted donor rows outlive the engine.

The engine's prefix index (``ServeEngine._prefix_index``) maps
block-aligned prompt heads to *resident* slot rows; it dies with the
engine, and a donor evicted to make room (slot reassigned, pad-lane
borrow) is forgotten. :class:`PrefixStore` is the spill target: a
host-memory LRU bounded by ``capacity_bytes`` holding, per stored prompt,
the full gathered state rows of the donor slot as host CPU tensors copied
off the card at spill time, so the store survives the engine that filled
it. The engine spills into it at eviction time
(``ServeEngine._index_drop_slot``), and a fresh or restored engine
*adopts* the hottest entries back into free slots
(``ServeEngine.adopt_prefixes``), so the next admission round matches
warm rows instead of prefilling cold.

The byte budget counts each leaf at its own element size: a bfloat16 row
costs 2 bytes per element, as the reference's numpy bfloat16 rows do.

Crash safety rides ``ft.checkpoint``'s atomics: ``save()`` writes the
whole store as one checkpoint step (tmp dir + rename + atomic LATEST
pointer) in the reference's layout, and ``load()`` reads the latest, so
each package loads a store the other saved. Entries carry the fingerprint
of the runner and state geometry that produced them; adopting against
another geometry raises instead of placing mismatched rows.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.ft.checkpoint import (latest_step, restore_checkpoint,
                                       save_checkpoint)

__all__ = ["PrefixStore"]


def _entry_nbytes(prompt: np.ndarray, rows: Dict[str, torch.Tensor]) -> int:
    return int(prompt.nbytes) + int(sum(t.numel() * t.element_size()
                                        for t in rows.values()))


class PrefixStore:
    """LRU-bounded host store of ``{prompt -> donor state rows}``.

    ``rows`` is the flat leaf dict of ``guard.flatten_state_tree`` over a
    single-slot ``gather_state``: one row per leaf, host tensors (numpy
    arrays are taken too). Entries are keyed by the full resident prompt
    (the engine re-derives every block-aligned prefix at adoption); a
    ``put`` and a ``touch`` bump recency, so adoption takes the
    most-recently-useful entries first.

    ``fingerprint`` pins the state geometry (runner class, cache_len, leaf
    shapes and dtypes); ``put``/adopt against another geometry raises.
    """

    def __init__(self, capacity_bytes: int = 64 << 20,
                 persist_dir: Optional[str] = None):
        if int(capacity_bytes) < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.persist_dir = persist_dir
        self.fingerprint: Optional[str] = None
        self._entries: "OrderedDict[bytes, Tuple[np.ndarray, Dict[str, torch.Tensor]]]" = OrderedDict()
        self._nbytes = 0
        self.spills = 0          # accepted puts
        self.evictions = 0       # LRU-evicted entries (capacity pressure)

    # -- core ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def _check_fingerprint(self, fingerprint: str, op: str) -> None:
        if self.fingerprint is None:
            self.fingerprint = str(fingerprint)
        elif self.fingerprint != str(fingerprint):
            raise ValueError(
                f"prefix store {op} geometry mismatch: store holds rows "
                f"for {self.fingerprint!r}, engine is "
                f"{str(fingerprint)!r} — a store is only shareable "
                f"between identically-configured engines")

    def put(self, prompt: np.ndarray, rows: Dict[str, torch.Tensor],
            fingerprint: str) -> bool:
        """Spill one donor's rows. Returns False (and stores nothing) for
        an entry that alone exceeds the byte budget; otherwise inserts,
        bumps recency, and LRU-evicts colder entries down to capacity."""
        self._check_fingerprint(fingerprint, "put")
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int32)
                                      .reshape(-1))
        rows = {str(k): torch.as_tensor(v).cpu() for k, v in rows.items()}
        nb = _entry_nbytes(prompt, rows)
        if nb > self.capacity_bytes:
            return False
        key = prompt.tobytes()
        old = self._entries.pop(key, None)
        if old is not None:
            self._nbytes -= _entry_nbytes(old[0], old[1])
        self._entries[key] = (prompt, rows)
        self._nbytes += nb
        self.spills += 1
        while self._nbytes > self.capacity_bytes:
            _, (p, r) = self._entries.popitem(last=False)
            self._nbytes -= _entry_nbytes(p, r)
            self.evictions += 1
        return True

    def hottest(self) -> Iterator[Tuple[np.ndarray, Dict[str, torch.Tensor]]]:
        """Yield ``(prompt, rows)`` most-recently-used first (adoption
        order). Snapshots the order up front so the consumer may ``put``
        or touch entries while iterating."""
        for key in list(reversed(self._entries)):
            e = self._entries.get(key)
            if e is not None:
                yield e

    def touch(self, prompt: np.ndarray) -> bool:
        """Bump an entry's recency (an adopted entry is hot). Returns
        whether the entry exists."""
        key = (np.asarray(prompt, np.int32).reshape(-1)).tobytes()
        if key in self._entries:
            self._entries.move_to_end(key)
            return True
        return False

    # -- persistence (ft.checkpoint atomics) --------------------------------
    def save(self, step: int = 0) -> str:
        """Persist the whole store as one atomic checkpoint step under
        ``persist_dir``. Entries are written coldest first so ``load``
        rebuilds the exact LRU order."""
        if self.persist_dir is None:
            raise ValueError("save() needs persist_dir")
        meta = {
            "version": 1,
            "fingerprint": self.fingerprint,
            "capacity_bytes": self.capacity_bytes,
            "prompts": [],
            "row_keys": [],
        }
        state: Dict[str, object] = {}
        for i, (prompt, rows) in enumerate(self._entries.values()):
            meta["prompts"].append(prompt.tolist())
            meta["row_keys"].append(sorted(rows))
            state[f"e{i:05d}"] = dict(rows)
        state["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                      np.uint8)
        return save_checkpoint(self.persist_dir, int(step), state)

    @classmethod
    def load(cls, persist_dir: str,
             capacity_bytes: Optional[int] = None) -> "PrefixStore":
        """Rebuild a store from the latest persisted step (an empty store
        if none exists yet); rows load as host tensors. ``capacity_bytes``
        overrides the persisted budget (loading into a smaller budget
        LRU-evicts the coldest entries at once)."""
        step = latest_step(persist_dir)
        if step is None:
            return cls(capacity_bytes=capacity_bytes or (64 << 20),
                       persist_dir=persist_dir)
        state = restore_checkpoint(persist_dir, int(step), device="cpu")
        meta = json.loads(state["meta"].numpy().tobytes().decode("utf-8"))
        if int(meta.get("version", 0)) != 1:
            raise ValueError(
                f"prefix store at {persist_dir} has format version "
                f"{meta.get('version')!r}; this build reads version 1")
        store = cls(capacity_bytes=capacity_bytes
                    or int(meta["capacity_bytes"]),
                    persist_dir=persist_dir)
        store.fingerprint = meta["fingerprint"]
        for i, (prompt, keys) in enumerate(zip(meta["prompts"],
                                               meta["row_keys"])):
            rows = {k: state[f"e{i:05d}"][k] for k in keys}
            store.put(np.asarray(prompt, np.int32), rows,
                      store.fingerprint)
        store.spills = 0       # loading is not spilling
        return store

    def as_dict(self) -> Dict[str, object]:
        return {
            "entries": len(self._entries),
            "nbytes": self._nbytes,
            "capacity_bytes": self.capacity_bytes,
            "spills": self.spills,
            "evictions": self.evictions,
        }
