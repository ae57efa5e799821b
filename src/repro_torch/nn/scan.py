"""Time scan over the leading axis with per-chunk recompute: the reference's
``chunked_time_scan``.

Run step by step under autograd, a scan keeps every step's intermediates
for the backward: for a Mamba or RWKV state that is T copies of (B, d_inner,
d_state) or (B, H, hd, hd). With ``remat`` set and a gradient recorded, the
scan runs in chunks of ``chunk`` steps, each under
``torch.utils.checkpoint``: the forward keeps only the chunk-boundary
carries, and the backward recomputes one chunk at a time (memory ÷ chunk,
the chunks' forward twice). The ``T % chunk`` tail runs plain and is never
padded, as in the reference (padding would corrupt the carry with phantom
steps). The checkpoint is the non-reentrant kind, so it nests inside the
layer-level recompute of ``remat="block"``. Under ``torch.no_grad``
(serving) nothing is kept for a backward and every setting runs the plain
loop. Recompute changes no value and no gradient.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_time_scan"]


def _loop(step_fn: Callable, carry, xs):
    # one unbind per input: its backward stacks the steps' grads once,
    # where a slice per step would make a full-size zero grad per step
    ys = []
    for xs_t in zip(*(a.unbind(0) for a in xs)):
        carry, y = step_fn(carry, xs_t)
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_time_scan(step_fn: Callable, carry, xs: Tuple[torch.Tensor, ...],
                      *, chunk: int = 256, remat: bool = True):
    """``step_fn(carry, xs_t) -> (carry, y_t)`` over ``xs``, a tuple of
    time-major tensors ``(T, ...)``; ``xs_t`` is the tuple of their t-th
    slices. Returns ``(carry, ys)`` with the ``y_t`` stacked time-major,
    as ``lax.scan``. With ``remat`` and a gradient recorded, each full
    chunk of ``chunk`` steps is recomputed in the backward (see the module
    docstring)."""
    if not (remat and torch.is_grad_enabled()):
        return _loop(step_fn, carry, xs)
    T = xs[0].shape[0]
    chunk = max(1, min(chunk, T))
    n = T // chunk
    ys = []
    for c in range(n):
        part = tuple(a[c * chunk:(c + 1) * chunk] for a in xs)
        carry, y = checkpoint(_loop, step_fn, carry, part,
                              use_reentrant=False)
        ys.append(y)
    if n * chunk < T:
        carry, y = _loop(step_fn, carry, tuple(a[n * chunk:] for a in xs))
        ys.append(y)
    return carry, torch.cat(ys)
