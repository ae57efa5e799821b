"""ModelRunner — the protocol between :class:`ServeEngine` and a model.

The engine schedules requests and buckets launch shapes; everything
model-shaped lives behind a runner, which owns the per-slot *state* (the
KV caches) and exposes the operations the engine composes:

* ``init_state(batch)`` — fresh state with one row per slot;
* ``prefill(tokens, positions, state, slot_idx)`` — run a bucket-shaped
  prompt group on fresh rows and place them into ``state`` at
  ``slot_idx``; returns ``(last_logits, ok, state)``;
* ``decode(tokens, state, pos, slot_idx)`` — gather the rows named by
  ``slot_idx``, decode one token, place them back; returns
  ``(logits, ok, state)``;
* ``gather_state`` / ``place_state`` — row surgery.

``ok[j]`` flags that row j's logits are all finite. State tensors are
preallocated once per engine and updated in place (``place_state`` is an
indexed copy into them); gathered rows are fresh copies the model may
write into.

**Pad contract.** Prefill buckets are LEFT-padded: real tokens sit
rightmost, pad lanes carry negative positions, and attention masks every
key with ``kv_pos < 0`` — so the same request produces the same tokens at
any bucket shape. The reference's prefix-cache seeding path is not ported.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["ModelRunner", "DecoderRunner"]


class ModelRunner:
    """Base runner: holds the model/config; subclasses implement the
    protocol above."""

    def __init__(self, model, cfg: ModelConfig, cache_len: int):
        self.model = model
        self.cfg = cfg
        self.cache_len = int(cache_len)

    def specs(self):
        return self.model.specs()

    def init_state(self, batch: int):
        raise NotImplementedError

    def prefill(self, tokens, positions, state, slot_idx):
        raise NotImplementedError

    def decode(self, tokens, state, pos, slot_idx):
        raise NotImplementedError

    def gather_state(self, state, idx):
        raise NotImplementedError

    def place_state(self, state, sub, idx):
        raise NotImplementedError


class DecoderRunner(ModelRunner):
    """Runner over :class:`HybridDecoderLM`. State: the model's cache, a
    list with one ``{"k", "v", "pos"}`` dict per layer, slot axis 0."""

    def init_state(self, batch: int) -> List[dict]:
        return self.model.init_cache(batch, self.cache_len)

    @torch.no_grad()
    def prefill(self, tokens, positions, state, slot_idx):
        fresh = self.init_state(tokens.shape[0])
        logits, filled = self.model.forward(tokens, positions=positions,
                                            cache=fresh, logits_mode="last")
        last = logits[:, -1]
        ok = torch.isfinite(last).all(dim=-1)
        return last, ok, self.place_state(state, filled, slot_idx)

    @torch.no_grad()
    def decode(self, tokens, state, pos, slot_idx):
        sub = self.gather_state(state, slot_idx)
        logits, sub = self.model.decode_step(tokens, sub, pos)
        ok = torch.isfinite(logits).all(dim=-1)
        return logits, ok, self.place_state(state, sub, slot_idx)

    def gather_state(self, state, idx):
        return [{n: t[idx] for n, t in layer.items()} for layer in state]

    def place_state(self, state, sub, idx):
        for dst, src in zip(state, sub):
            for n, t in dst.items():
                t[idx] = src[n].to(t.dtype)
        return state
