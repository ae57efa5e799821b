"""Losses. The headline trick is **chunked cross-entropy**: for a large
vocabulary the (B, S, V) logits tensor would dwarf the model, so the loss
walks sequence chunks, computing logits → logsumexp → nll per chunk and
keeping only scalars. Each chunk is recomputed in the backward
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` on its
scan body), so the logits of all chunks are never live together.

Vocab-parallel (``vocab_shard`` = (the ``model`` axis, first row), the
table being this rank's rows): each chunk's logits are this rank's slice;
the log-sum-exp is global, from an all-reduced max and an all-reduced sum
of exponentials; the label logit comes from the rank that holds the
label's row (the others add zeros); ``z_loss`` takes the global
log-sum-exp. The hidden states enter the region once, so their gradient
partials are summed over the axis."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (all_reduce_max, region_input,
                                       region_output)

__all__ = ["chunked_cross_entropy", "softmax_cross_entropy"]


def softmax_cross_entropy(logits, labels, mask=None, z_loss: float = 0.0):
    """logits (..., V), labels (...) int. Returns (mean nll, metrics)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss > 0:
        nll = nll + z_loss * lse.square()
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / total, {"tokens": total}


def _chunk_nll(h, r, m, tf, z_loss: float, axis=None):
    """Masked nll sum and token count of one (B, c) chunk; over ``axis``
    the vocab-parallel one (module docstring)."""
    h32 = h.float()
    logits = h32 @ tf.T                                   # (B, c, V)
    if axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = (h32 * r.float()).sum(-1)
    else:
        top = all_reduce_max(logits.detach().amax(dim=-1), axis)
        se = torch.exp(logits - top[..., None]).sum(-1)
        lse = top + torch.log(region_output(se, axis))
        ll = region_output((h32 * r.float()).sum(-1), axis)
    nll = lse - ll
    if z_loss > 0:
        nll = nll + z_loss * lse.square()
    mf = m.float()
    return (nll * mf).sum(), mf.sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,                 # (B, S, D) final hidden states
    table: torch.Tensor,                  # (V, D) tied embedding
    labels: torch.Tensor,                 # (B, S) int
    mask: Optional[torch.Tensor] = None,  # (B, S) 1 = count
    *,
    z_loss: float = 0.0,
    chunk: int = 512,
    vocab_shard=None,
) -> Tuple[torch.Tensor, dict]:
    """CE where logits are materialized only one sequence chunk at a
    time; the label logit is ``<h, table[label]>`` from one row gather.
    ``vocab_shard`` = (axis, first row): ``table`` is this rank's rows of
    the output table, vocab-parallel over ``axis``."""
    B, S, D = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    axis = None
    if vocab_shard is None:
        rows = table[labels.long()]                       # (B, S', D)
    else:
        axis, start = vocab_shard
        rel = labels.long() - start
        mine = (rel >= 0) & (rel < table.shape[0])
        rows = table[rel.clamp(0, table.shape[0] - 1)] * mine[..., None].to(
            table.dtype)
        hidden = region_input(hidden, axis)
    tf = table.float()
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        args = (hidden[:, c0:c0 + chunk], rows[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], tf, z_loss, axis)
        t, c = (checkpoint(_chunk_nll, *args, use_reentrant=False) if grad
                else _chunk_nll(*args))
        tot, cnt = tot + t, cnt + c
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt, {"tokens": cnt}
