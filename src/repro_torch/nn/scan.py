"""Time scan over the leading axis: the reference's ``chunked_time_scan``.

The reference scans chunks of steps with a checkpointed chunk body, so its
backward keeps only the chunk-boundary states. The port runs the steps in a
Python loop with the same ``(carry, ys)`` contract; the recurrent mixers
call it under ``torch.no_grad`` (serving), where nothing is kept for a
backward and ``chunk``/``remat`` change nothing. Per-chunk recompute waits
for the slice that trains these families.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["chunked_time_scan"]


def chunked_time_scan(step_fn: Callable, carry, xs: Tuple[torch.Tensor, ...],
                      *, chunk: int = 256, remat: bool = True):
    """``step_fn(carry, xs_t) -> (carry, y_t)`` over ``xs``, a tuple of
    time-major tensors ``(T, ...)``; ``xs_t`` is the tuple of their t-th
    slices. Returns ``(carry, ys)`` with the ``y_t`` stacked time-major,
    as ``lax.scan``. ``chunk`` and ``remat`` are accepted for the
    reference's signature and have no effect (see the module docstring)."""
    del chunk, remat
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step_fn(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)
