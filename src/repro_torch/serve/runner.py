"""ModelRunner — the protocol between :class:`ServeEngine` and a model.

The engine schedules requests and buckets launch shapes; everything
model-shaped lives behind a runner, which owns the per-slot *state* (the
KV caches) and exposes the operations the engine composes:

* ``init_state(batch)`` — fresh state with one row per slot;
* ``prefill(tokens, positions, state, slot_idx, donor_idx=None,
  match_len=None, extra=None)`` — run a bucket-shaped prompt group and
  place its rows into ``state`` at ``slot_idx``; returns ``(last_logits,
  ok, state)``. Without ``donor_idx`` the group starts from fresh rows;
  with it (the prefix cache) row j starts from a copy of slot
  ``donor_idx[j]``'s rows with every entry at a position ``>=
  match_len[j]`` masked, and ``tokens`` carry only the unmatched tail.
  ``extra`` is the chunk's stacked per-request conditioning (the enc-dec
  encoder frames); decoder runners take none;
* ``decode(tokens, state, pos, slot_idx)`` — gather the rows named by
  ``slot_idx``, decode one token, place them back; returns
  ``(logits, ok, state)``;
* ``gather_state`` / ``place_state`` / ``reset_rows`` — row surgery (slot
  compaction, scrubbing a poisoned slot back to blank rows).

``ok[j]`` flags that row j's logits are all finite: the engine's
per-request NaN guard reads it. State tensors are preallocated once per
engine and updated in place (``place_state`` is an indexed copy into
them); gathered rows are fresh copies the model may write into.

**Pad contract.** Prefill buckets are LEFT-padded: real tokens sit
rightmost, pad lanes carry negative positions. Attention masks every key
with ``kv_pos < 0``; recurrent mixers (mamba, rwkv) get the validity mask
``positions >= 0`` from the model, so pads never enter a token shift, a
conv window or a state update — the same request produces the same tokens
at any bucket shape. Every forward dispatches MoE layers with
``moe_no_drop=True`` (no capacity drops, so a token's output depends on
its own row only).

**Capability flags.** ``supports_prefix_cache`` records whether state rows
are position-sliceable (a donor's rows for positions ``[0, m)`` can seed
another request), with ``prefix_cache_unsupported_reason`` saying why not:
full-length KV caches are; recurrent state, enc-dec cross-attention state
and local-attention rings shorter than ``cache_len`` (donor rows past the
window are overwritten) are not. ``requires_extra`` marks families whose
requests carry per-request conditioning (``Request.extra``: the enc-dec
encoder frames), and ``validate_request`` checks a request against it both
ways.

:func:`make_runner` picks the runner for a config: :class:`EncDecRunner`
for the enc-dec family, :class:`RecurrentRunner` when recurrent mixers are
present, else :class:`DecoderRunner`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import local_attn_cache_len

__all__ = ["ModelRunner", "DecoderRunner", "RecurrentRunner",
           "EncDecRunner", "make_runner", "recurrent_mixer_names"]


def recurrent_mixer_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """Sorted unique recurrent mixer kinds ('mamba'/'rwkv') in ``cfg`` —
    empty for pure-attention decoder families."""
    if cfg.family == "encdec":
        return ()
    names = {lspec.mixer for group in cfg.layer_groups()
             for lspec in group.layers if lspec.mixer in ("mamba", "rwkv")}
    return tuple(sorted(names))


class ModelRunner:
    """Base runner: holds the model/config and the capability flags;
    subclasses implement the protocol above."""

    #: whether state rows are position-sliceable (prefix-cache donors)
    supports_prefix_cache: bool = False
    #: why not, when they are not
    prefix_cache_unsupported_reason: str = ""
    #: whether requests must carry per-request conditioning (Request.extra)
    requires_extra: bool = False

    def __init__(self, model, cfg: ModelConfig, cache_len: int):
        self.model = model
        self.cfg = cfg
        self.cache_len = int(cache_len)

    def specs(self):
        return self.model.specs()

    def init_state(self, batch: int):
        raise NotImplementedError

    def prefill(self, tokens, positions, state, slot_idx, donor_idx=None,
                match_len=None, extra=None):
        raise NotImplementedError

    def decode(self, tokens, state, pos, slot_idx):
        raise NotImplementedError

    def gather_state(self, state, idx):
        raise NotImplementedError

    def place_state(self, state, sub, idx):
        raise NotImplementedError

    def reset_rows(self, state, idx):
        """Overwrite the rows named by ``idx`` with fresh (blank) rows."""
        return self.place_state(state, self.init_state(int(idx.shape[0])),
                                idx)

    def prewarm_extra(self, batch: int):
        """Placeholder ``extra`` for prewarm launches (families with
        ``requires_extra``); None otherwise."""
        return None

    def validate_request(self, r) -> None:
        """Family-specific admission checks beyond the engine's shared
        length/budget contract: a decoder family takes no ``extra``."""
        if getattr(r, "extra", None) is not None:
            raise ValueError(
                f"request carries extra conditioning but "
                f"{type(self).__name__} serves a decoder-only family that "
                f"takes none (drop Request.extra, or serve an enc-dec "
                f"config)")


class DecoderRunner(ModelRunner):
    """Runner over :class:`HybridDecoderLM`. State: the model's cache, a
    list with one dict per layer, every leaf with the slot axis at 0.

    Prefix reuse is supported unless an ``attn_local`` layer keeps a ring
    shorter than ``cache_len``: such a ring has already overwritten a
    donor's rows past the window."""

    supports_prefix_cache = True

    def __init__(self, model, cfg: ModelConfig, cache_len: int):
        super().__init__(model, cfg, cache_len)
        if any(lspec.mixer == "attn_local" for lspec in cfg.layer_specs()):
            ring = local_attn_cache_len(cfg, self.cache_len)
            if ring < self.cache_len:
                self.supports_prefix_cache = False
                self.prefix_cache_unsupported_reason = (
                    f"prefix_cache needs full-length KV caches, but "
                    f"'attn_local' layers keep a ring of {ring} < "
                    f"cache_len={self.cache_len} entries: donor rows "
                    f"past the window are overwritten and the shared "
                    f"head cannot be copied")

    def init_state(self, batch: int) -> List[dict]:
        return self.model.init_cache(batch, self.cache_len)

    @torch.no_grad()
    def prefill(self, tokens, positions, state, slot_idx, donor_idx=None,
                match_len=None, extra=None):
        """Prefill a bucket-shaped group from fresh rows, or (``donor_idx``
        given: the prefix cache) from donor rows seeded by
        :meth:`_seed_state`; a missing match passes the row's own slot
        with ``match_len`` 0, whose fully masked seed acts as fresh rows."""
        if donor_idx is None:
            seed = self.init_state(tokens.shape[0])
        else:
            seed = self._seed_state(state, donor_idx, match_len)
        logits, filled = self.model.forward(tokens, positions=positions,
                                            cache=seed, logits_mode="last",
                                            moe_no_drop=True)
        last = logits[:, -1]
        ok = torch.isfinite(last).all(dim=-1)
        return last, ok, self.place_state(state, filled, slot_idx)

    def _seed_state(self, state, donor_idx, match_len):
        """Bucket-shaped rows copied from the donor slots: entries at
        positions ``>= match_len`` (the donor's tail and decode rows) get
        ``pos -> -1`` so only the matched head survives the attention mask,
        and the k/v of every entry outside the head (pads included) are
        blanked. The reference leaves those k/v in place; a masked NaN
        there still reaches attention (``0 · NaN``), and a decode pad lane
        that feeds a failed request's last token back writes NaN rows into
        its freed slot, which the next request seeded from that slot (a
        miss seeds from its own slot) would read."""
        m = match_len[:, None]
        out = []
        for layer in self.gather_state(state, donor_idx):
            pos = layer["pos"]
            head = ((pos >= 0) & (pos < m))[..., None, None]
            out.append({"pos": pos.masked_fill(pos >= m, -1),
                        "k": layer["k"].masked_fill(~head, 0),
                        "v": layer["v"].masked_fill(~head, 0)})
        return out

    @torch.no_grad()
    def decode(self, tokens, state, pos, slot_idx):
        sub = self.gather_state(state, slot_idx)
        logits, sub = self.model.decode_step(tokens, sub, pos,
                                             moe_no_drop=True)
        ok = torch.isfinite(logits).all(dim=-1)
        return logits, ok, self.place_state(state, sub, slot_idx)

    def gather_state(self, state, idx):
        return [{n: t[idx] for n, t in layer.items()} for layer in state]

    def place_state(self, state, sub, idx):
        for dst, src in zip(state, sub):
            for n, t in dst.items():
                t[idx] = src[n].to(t.dtype)
        return state


class RecurrentRunner(DecoderRunner):
    """Runner for decoder families with recurrent mixers (rwkv6, jamba's
    mamba layers). The device path is :class:`DecoderRunner`'s: pad
    invariance lives in the model, whose ``positions >= 0`` validity mask
    keeps left-pad lanes out of token shifts, conv windows and state
    updates. Recurrent state is not position-sliceable — one state per
    slot encodes the whole prompt — so it can seed no prefix reuse."""

    supports_prefix_cache = False

    def __init__(self, model, cfg: ModelConfig, cache_len: int):
        super().__init__(model, cfg, cache_len)
        mix = recurrent_mixer_names(cfg)
        self.prefix_cache_unsupported_reason = (
            f"prefix reuse copies per-position donor rows, but "
            f"{'/'.join(mix)} layers hold recurrent state with no "
            f"per-position rows to slice — a donor's state encodes its "
            f"entire prompt (serve this family with prefix_cache=False)")


class EncDecRunner(ModelRunner):
    """Runner over :class:`EncDecLM` (seamless-m4t). Requests carry the
    encoder frames as ``Request.extra`` (shape ``(enc_len, d_model)``);
    the encoder runs inside the prefill, once per request, and the
    resulting cross-attention K/V live in the state beside the decoder's
    self-attention rings, so decode steps never run the encoder again.

    State: the model's cache, ``{"self": [...], "cross": [...]}`` with one
    ``{"k", "v", "pos"}`` dict per decoder layer in each list, every leaf
    with the slot axis at 0 (the reference stacks layers on axis 0 and
    keeps the slot axis at 1). Decode gathers and places every active
    slot's whole cross cache, as the reference does."""

    requires_extra = True
    supports_prefix_cache = False
    prefix_cache_unsupported_reason = (
        "enc-dec cross-attention state is computed per request from "
        "its encoder frames; donor rows cannot stand in for another "
        "request's conditioning (serve with prefix_cache=False)")

    def __init__(self, model, cfg: ModelConfig, cache_len: int):
        super().__init__(model, cfg, cache_len)
        self.enc_len = int(cfg.enc_seq or cache_len)

    def init_state(self, batch: int) -> dict:
        return self.model.init_cache(batch, self.cache_len)

    @torch.no_grad()
    def prefill(self, tokens, positions, state, slot_idx, donor_idx=None,
                match_len=None, extra=None):
        """``extra`` (Bb, enc_len, d_model) are the chunk's stacked encoder
        frames; the encoder pass runs here and its cross K/V are placed
        into the slot state with the rest of the rows."""
        fresh = self.init_state(tokens.shape[0])
        logits, filled = self.model.forward(extra, tokens, cache=fresh,
                                            logits_mode="last",
                                            positions=positions)
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
        return {part: [{n: t[idx] for n, t in layer.items()}
                       for layer in layers]
                for part, layers in state.items()}

    def place_state(self, state, sub, idx):
        for part, layers in state.items():
            for dst, src in zip(layers, sub[part]):
                for n, t in dst.items():
                    t[idx] = src[n].to(t.dtype)
        return state

    def prewarm_extra(self, batch: int) -> torch.Tensor:
        """Zero frames on the runner's device: prewarm launches run the
        encoder on silence (finite), onto rows the next admission
        replaces."""
        return torch.zeros((batch, self.enc_len, self.cfg.d_model),
                           dtype=torch.float32, device=self.model.device)

    def validate_request(self, r) -> None:
        extra = getattr(r, "extra", None)
        if extra is None:
            raise ValueError(
                f"enc-dec serving needs encoder frames per request: set "
                f"Request.extra to an ({self.enc_len}, {self.cfg.d_model}) "
                f"array of frame embeddings")
        a = np.asarray(extra)
        if a.shape != (self.enc_len, self.cfg.d_model):
            raise ValueError(
                f"Request.extra has shape {a.shape}, expected "
                f"({self.enc_len}, {self.cfg.d_model}) "
                f"(enc_seq x d_model for this config)")


def make_runner(model, cfg: ModelConfig, cache_len: int) -> ModelRunner:
    """The runner for a config: enc-dec family -> :class:`EncDecRunner`,
    recurrent mixers present -> :class:`RecurrentRunner`, else
    :class:`DecoderRunner`."""
    if cfg.family == "encdec":
        return EncDecRunner(model, cfg, cache_len)
    if recurrent_mixer_names(cfg):
        return RecurrentRunner(model, cfg, cache_len)
    return DecoderRunner(model, cfg, cache_len)
