"""Mixture-of-Experts with scatter-based capacity dispatch (GShard-style).

The reference's ``repro.nn.moe.MoE``, line for line: an f32 softmax router
(a dense GEMM, never circulant), top-k with renormalised gates, each
(token, slot)'s position in its expert's capacity from a stable sort, a
scatter into an ``(E, C, d)`` buffer, the experts as one stacked
:class:`SwiGLU` (three grouped ``bc_matmul`` launches on the kernel impl,
where the reference ``jax.vmap``s one expert), then a gather and the
gate-weighted combine, and the Switch load-balance aux loss.

When a gradient is recorded the experts run under ``torch.utils.checkpoint``,
as the reference's ``@jax.checkpoint`` expert: their hidden ``(E, C, d_ff)``
is recomputed in the backward instead of kept, which changes no value. On
the kernel impl the backward of each expert projection is one grouped
``bc_matmul`` (dx) and one grouped ``bc_dw`` (dw) over all experts.

Under data parallelism each rank holds a contiguous, rank-major block of
the global batch, while the reference routes the global batch. Inside
:func:`global_routing` (the data-parallel train step opens it,
``dist.data_parallel.DataParallel.routing``) a training forward routes as
the reference does: one all-gather of the per-expert counts ``(W, E)``
per MoE layer call gives the capacity ``C`` from the global token count,
each (token, slot)'s queue position as its local stable-sort position plus
the counts of the ranks before it, and the global ``f`` of the aux loss.
Each rank's aux takes the global ``f`` against its local mean ``P``, so
the mean over ranks is the full batch's aux and its gradient is exact. A
rank's dispatch buffer holds ``min(C, N_local)`` rows per expert (a rank
places at most ``N_local`` tokens on an expert). Where remat recomputes a
block in the backward, its MoE call gathers the counts again: every rank
runs the same backward, so the collectives stay in the same order. Serving
(``no_drop``) depends on no other row and never gathers. ``dropped`` holds
the (token, slot) pairs the last forward dropped for capacity.

Under tensor parallelism the experts are split over the ``model`` axis
(``tp`` = (axis, first expert, end expert), set by
``dist.tensor_parallel.shard_model``). The tokens, the f32 router, the
routing and the aux loss stay replicated on every rank of the axis, so
capacity and drops are the global routing's. Each rank dispatches only
the (token, slot) pairs of its experts into an ``(E / model, C, d)``
buffer, runs them as one grouped launch per projection, and combines
them; the partial combines are summed over the axis. The tokens and the
gates enter that region (their gradient partials summed), so the
router's and the aux loss's gradients stay whole on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SWMConfig
from repro_torch.dist.sharding import region_input, region_output
from repro_torch.nn.ffn import SwiGLU
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import load_tree, module_tree

__all__ = ["MoE", "GlobalRouting", "global_routing", "top_k_lower_index"]

# The routing of the data-parallel step in progress (None: route the local
# batch). A module global, not thread-local: on CUDA a remat recompute runs
# on autograd's device thread.
_ROUTING = [None]


class GlobalRouting:
    """A data-parallel group whose ranks hold equal, rank-major blocks of
    one global batch; counts the collectives the MoE layers run and the
    bytes they send."""

    def __init__(self, group, world: int, rank: int):
        self.group, self.world, self.rank = group, int(world), int(rank)
        self.collectives = self.bytes = 0

    def gather_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Every rank's per-expert counts, ``(W, E)`` in rank order."""
        from repro_torch.dist.sharding import all_gather_list

        self.collectives += 1
        self.bytes += counts.numel() * counts.element_size()
        return torch.stack(all_gather_list(counts, self.group))


@contextlib.contextmanager
def global_routing(routing: Optional[GlobalRouting]):
    """Route every training MoE forward inside on the global batch of
    ``routing`` (None: the local batch)."""
    prev = _ROUTING[0]
    _ROUTING[0] = routing
    try:
        yield routing
    finally:
        _ROUTING[0] = prev


def _run_experts(experts, disp, tree):
    """``experts(disp)`` on the tables ``tree``. The recompute in the
    backward takes the tables the forward took: an FSDP layer's gathered
    ones, which its module holds only inside the layer's forward."""
    held = module_tree(experts)
    load_tree(experts, tree)
    try:
        return experts(disp)
    finally:
        load_tree(experts, held)


def top_k_lower_index(probs: torch.Tensor, k: int):
    """The ``k`` largest entries of each row and their indices, exact ties
    broken toward the lower index as ``lax.top_k`` breaks them (a stable
    descending sort keeps tied entries in index order; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(nn.Module):
    """x (B, S, d) -> (y (B, S, d), aux scalar f32). Children ``router``
    (dense f32 ``(d, E)``) and ``experts`` (SwiGLU stacked over E)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25,
                 swm: Optional[SWMConfig] = None, dtype: str = "bfloat16"):
        super().__init__()
        self.d_model, self.d_ff = int(d_model), int(d_ff)
        self.n_experts, self.top_k = int(n_experts), int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.add_module("router", Linear(d_model, n_experts, family="router",
                                         swm=swm, dtype="float32",
                                         in_axis="embed"))
        self.add_module("experts", SwiGLU(d_model, d_ff, swm=swm,
                                          family="expert", dtype=dtype,
                                          expert_dims=(n_experts,)))
        self.tp = None

    def specs(self):
        return {n: self._modules[n].specs() for n in ("router", "experts")}

    def capacity(self, n_tokens: int, no_drop: bool) -> int:
        """Slots per expert: N under ``no_drop`` (a token's top-k experts
        are distinct, so no expert receives more than N), else the
        capacity-factor share, at least 1 and at most N."""
        if no_drop:
            return n_tokens
        c = max(1, int(n_tokens * self.top_k / self.n_experts
                       * self.capacity_factor))
        return min(c, n_tokens)

    def forward(self, x: torch.Tensor, no_drop: bool = False):
        """``no_drop=True`` is the serving dispatch: nothing is dropped, so
        each token's output depends on its own row only, whatever the batch
        composition and bucket padding. Training keeps the capacity drop
        path, which the aux loss is tuned against."""
        B, S, d = x.shape
        E, T = self.n_experts, self.top_k
        N = B * S
        xt = x.reshape(N, d)

        logits = self._modules["router"](xt).float()              # (N, E)
        probs = torch.softmax(logits, dim=-1)
        gate, expert_idx = top_k_lower_index(probs, T)              # (N, T)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        flat_e = expert_idx.reshape(-1)                            # (N·T,)
        route = None if no_drop else _ROUTING[0]
        # per-expert counts as exact f32 integers (index_add_: no host
        # sync, where bincount reads its input's max back)
        counts = torch.zeros(E, dtype=torch.float32,
                             device=x.device).index_add_(
            0, flat_e, torch.ones(N * T, dtype=torch.float32,
                                  device=x.device))                # (E,)
        if route is None:
            n_global, before, total = N, None, counts
        else:
            every = route.gather_counts(counts)                    # (W, E)
            n_global = N * route.world
            before = every[:route.rank].sum(0).long()
            total = every.sum(0)
        C = self.capacity(n_global, no_drop)

        # position of each (token, slot) within its expert's capacity:
        # stable sort by expert, rank inside the expert's segment
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        seg_start = torch.searchsorted(
            sorted_e, torch.arange(E, device=x.device))            # (E,)
        pos_sorted = (torch.arange(N * T, device=x.device)
                      - seg_start[sorted_e])
        pos = torch.zeros(N * T, dtype=torch.long, device=x.device)
        pos[order] = pos_sorted
        pos = pos.reshape(N, T)
        # the global queue position: the ranks before this one come first
        keep = (pos if before is None else pos + before[expert_idx]) < C
        pos = torch.where(keep, pos, torch.zeros_like(pos))
        self.dropped = (~keep).sum()

        # dispatch: scatter-add tokens into (E, C, d). On CUDA the
        # accumulate is atomic, so its order is not fixed; the sum does not
        # depend on it: a kept (token, slot) owns its (expert, pos) slot
        # alone (positions are ranks within the expert), and a dropped one
        # adds an exact zero to slot 0, so every slot sums one value and
        # zeros
        axis, e0, e1 = self.tp if self.tp is not None else (None, 0, E)
        if self.tp is not None:
            # this rank's experts only: the others' pairs add exact zeros
            mine = (expert_idx >= e0) & (expert_idx < e1)
            keep = keep & mine
            local_idx = torch.where(mine, expert_idx - e0,
                                    torch.zeros_like(expert_idx))
            xt, gate = region_input(xt, axis), region_input(gate, axis)
        else:
            local_idx = expert_idx
        disp = torch.zeros((e1 - e0, min(C, N), d), dtype=x.dtype,
                           device=x.device)
        contrib = xt[:, None, :] * keep[..., None].to(x.dtype)      # (N,T,d)
        disp.index_put_((local_idx, pos), contrib, accumulate=True)

        experts = self._modules["experts"]
        y_exp = (checkpoint(_run_experts, experts, disp, module_tree(experts),
                            use_reentrant=False)
                 if torch.is_grad_enabled() else experts(disp))    # (E, C, d)

        # combine: each token's expert outputs, gate-weighted
        y_tok = y_exp[local_idx, pos]                              # (N, T, d)
        w = (gate * keep.to(gate.dtype))[..., None].to(x.dtype)
        y = region_output((y_tok * w).sum(dim=1), axis).reshape(B, S, d)

        # load-balance aux loss (Switch): E · Σ_e f_e · P_e
        # f global under data parallelism, P this rank's rows
        f = total / (n_global * T)
        P = probs.mean(dim=0)
        aux = E * torch.sum(f * P)
        return y, aux
