"""Data parallelism for the train step: batch shards, one bucketed grad
all-reduce, and ZeRO-1 optimizer moments.

Every rank holds the whole params (FSDP configs too: the port keeps params
whole on every rank) and takes its shard of each batch. After the backward,
the rank's grads, loss and metrics are averaged over the data axes with ONE
all-reduce of a flattened f32 buffer (a bf16 grad round-trips f32 exactly,
and a one-rank mean is bit-for-bit the mesh-less grad). Moments are held as
this rank's shard under ``dist.sharding.opt_shardings`` (ZeRO-1; the
state is made so by ``train.loop.init_train_state(opt_shardings=,
mesh=)``, and a step on whole moments raises): AdamW
updates the matching slice of each param, and the updated slices are
all-gathered, one collective per param dtype. Adafactor's row and column
means span a whole leaf (a repeated layer group's whole stack), so its
moments are stored sharded but gathered for the update.

A MoE model routes its tokens over the global batch, as the reference
does (:meth:`DataParallel.routing`, ``nn.moe.global_routing``): one
all-gather of per-expert counts per MoE layer call.

The mesh is a ``DeviceMesh`` with a ``"model"`` axis of size 1: tensor
parallelism is not ported, and a mesh that asks for it is refused. On a
``gloo`` group, collectives of CUDA tensors are staged through host memory
(``dist.sharding.all_reduce_flat`` / ``all_gather_list``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (all_gather_list, all_reduce_flat,
                                       axis_names, axis_size, batch_pspec,
                                       data_axes, dp_size, local_slices,
                                       opt_shardings, sharded_dim)
from repro_torch.nn.module import map_specs, tree_leaves, tree_map
from repro_torch.convert import layer_stacks
from repro_torch.optim.optimizers import (adafactor_consts, adafactor_group,
                                          adafactor_groups,
                                          adafactor_state_specs, adamw_consts,
                                          adamw_leaf, adamw_state_specs)

__all__ = ["DataParallel", "refuse_tensor_parallel"]


def refuse_tensor_parallel(mesh) -> None:
    """Raise when ``mesh`` asks for tensor parallelism (a ``model`` axis
    larger than 1), which the port does not run."""
    if "model" in axis_names(mesh) and axis_size(mesh, "model") > 1:
        raise NotImplementedError(
            f"mesh {dict(zip(axis_names(mesh), _sizes(mesh)))} has a 'model' "
            f"axis of {axis_size(mesh, 'model')}: tensor parallelism is not "
            f"ported; the port trains data-parallel on a (world, 1) mesh")


def _sizes(mesh):
    return [axis_size(mesh, a) for a in axis_names(mesh)]


@contextlib.contextmanager
def _counted(dp, ctx):
    with ctx as route:
        try:
            yield route
        finally:
            if route is not None:
                dp.collectives += route.collectives


def _slicer(sl) -> tuple:
    return tuple(slice(a, b) for a, b in sl)


class DataParallel:
    """The data-parallel half of one train step on ``mesh``.

    ``param_specs`` is the model's spec tree; ``cfg.optimizer`` picks the
    moment specs (``adamw``: ``m``/``v``; ``adafactor``: ``vr``/``vc``).
    ``state_shardings`` is the layout the state is held in (whole params,
    ZeRO-1 moments), the tree ``ft.TrainDriver`` and
    ``restore_checkpoint`` take; ``collectives`` counts the collectives
    issued so far."""

    def __init__(self, mesh, param_specs, cfg, tcfg):
        refuse_tensor_parallel(mesh)
        if not hasattr(mesh, "get_coordinate"):
            raise TypeError("data-parallel training needs a DeviceMesh "
                            "(launch.mesh.make_local_mesh); an abstract mesh "
                            "description holds no devices")
        self.mesh, self.cfg, self.tcfg = mesh, cfg, tcfg
        dp = data_axes(mesh)
        self.dp_entry = (dp if len(dp) > 1 else dp[0]) if dp else None
        self.world = dp_size(mesh)
        self.group = (mesh.get_group(dp[0]) if len(dp) == 1
                      else dist.group.WORLD)
        self.adafactor = cfg.optimizer == "adafactor"
        self.stacks = layer_stacks(cfg) if self.adafactor else ()
        self.mom_specs = (adafactor_state_specs(param_specs, tcfg,
                                                self.stacks)
                          if self.adafactor
                          else adamw_state_specs(param_specs, tcfg))
        self.opt_specs = {
            k: opt_shardings(mesh, v, fsdp=cfg.fsdp, low_tp=cfg.low_tp)
            for k, v in self.mom_specs.items()}
        self.state_shardings = {
            "params": map_specs(lambda path, s: (None,) * len(s.shape),
                                param_specs),
            "opt": self.opt_specs, "step": ()}
        self.collectives = 0

    def _all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        self.collectives += 1
        return all_gather_list(t, self.group)

    # -- the step ---------------------------------------------------------
    def local_batch(self, batch: Dict[str, torch.Tensor]):
        """This rank's rows of a global batch. With ``tcfg.microbatch`` = n
        > 1 the rank takes its shard of each of the n microbatches (the
        reference keeps data parallelism on the inner batch dim), so its
        rows split into n equal slices again; a batch whose microbatch the
        data axes do not divide stays whole on every rank."""
        n = self.tcfg.microbatch or 1
        out = {}
        for k, v in batch.items():
            B = v.shape[0]
            if n > 1 and B % n == 0:
                x = v.reshape(n, B // n, *v.shape[1:])
                spec = (None,) + batch_pspec(self.mesh, x.ndim - 1,
                                             batch=B // n)
                x = x[_slicer(local_slices(x.shape, spec, self.mesh))]
                out[k] = x.reshape(-1, *v.shape[1:])
            else:
                spec = batch_pspec(self.mesh, v.ndim, batch=B)
                out[k] = v[_slicer(local_slices(v.shape, spec, self.mesh))]
        return out

    def routing(self, batch, local):
        """The MoE routing context of one step (``nn.moe.global_routing``):
        the global batch's when this rank's ``local`` rows are a shard of
        ``batch``, else the local batch's. Its collectives join
        ``collectives`` when it closes."""
        from repro_torch.nn.moe import GlobalRouting, global_routing

        rows = lambda b: next(iter(b.values())).shape[0]
        route = None
        if self.world > 1 and rows(local) < rows(batch):
            route = GlobalRouting(self.group, self.world,
                                  dist.get_rank(self.group))
        return _counted(self, global_routing(route))

    def average(self, grads, loss, metrics):
        """Mean of grads, loss and metrics over the data ranks, with one
        all-reduce of a flattened f32 buffer; new tensors in each input's
        shape and dtype."""
        parts = tree_leaves(grads) + [loss] + tree_leaves(metrics)
        self.collectives += 1
        it = iter(all_reduce_flat(parts, self.group, divisor=self.world))
        g = tree_map(lambda _: next(it), grads)
        lo = next(it)
        return g, lo, tree_map(lambda _: next(it), metrics)

    def check_shards(self, opt) -> None:
        """Raise unless every moment has this rank's shard shape, as
        ``init_train_state(opt_shardings=, mesh=)`` makes them."""
        for key, specs in self.opt_specs.items():
            for t, full, spec in zip(tree_leaves(opt[key]),
                                     tree_leaves(self.mom_specs[key]),
                                     tree_leaves(specs)):
                want = tuple(b - a for a, b in local_slices(
                    full.shape, spec, self.mesh))
                if tuple(t.shape) != want:
                    raise ValueError(
                        f"moment {key!r} of shape {tuple(t.shape)} is not "
                        f"this rank's shard {want}: make the state with "
                        f"init_train_state(..., opt_shardings="
                        f"step.data_parallel.state_shardings['opt'], "
                        f"mesh=mesh)")

    def update(self, params, grads, opt, step: int) -> None:
        """The optimizer step on this rank's moment shards, then the
        params made whole again on every rank."""
        if self.adafactor:
            self._adafactor(params, grads, opt, step)
            return
        consts = adamw_consts(step, self.tcfg)
        gathered: Dict[torch.dtype, list] = {}
        for p, g, m, v, spec in zip(
                tree_leaves(params), tree_leaves(grads),
                tree_leaves(opt["m"]), tree_leaves(opt["v"]),
                tree_leaves(self.opt_specs["m"])):
            d = sharded_dim(spec, self.dp_entry)
            if d is None:
                adamw_leaf(p, g, m, v, consts, self.tcfg)
                continue
            sl = _slicer(local_slices(p.shape, spec, self.mesh))
            with torch.no_grad():
                p_loc = p[sl]
                adamw_leaf(p_loc, g[sl], m, v, consts, self.tcfg)
            gathered.setdefault(p.dtype, []).append((p, p_loc, d))
        with torch.no_grad():
            for leaves in gathered.values():
                flat = torch.cat([pl.reshape(-1) for _, pl, _ in leaves])
                chunks = self._all_gather(flat)
                off = 0
                for p, p_loc, d in leaves:
                    n = p_loc.numel()
                    p.copy_(torch.cat([c[off:off + n].reshape(p_loc.shape)
                                       for c in chunks], dim=d))
                    off += n

    def _adafactor(self, params, grads, opt, step: int) -> None:
        """Adafactor on whole moments: each sharded moment gathered, every
        group of ``adafactor_groups`` (a stack of per-layer leaves as one)
        updated whole, and this rank's shards written back."""
        consts = adafactor_consts(step, self.tcfg)
        ps, gs = tree_leaves(params), tree_leaves(grads)
        moms = {k: tree_leaves(opt[k]) for k in ("vr", "vc")}
        specs = {k: tree_leaves(self.opt_specs[k]) for k in ("vr", "vc")}
        for idx, stacked in adafactor_groups(params, self.stacks):
            full, cuts = {"vr": [], "vc": []}, []
            for key in ("vr", "vc"):
                for i in idx:
                    t, spec = moms[key][i], specs[key][i]
                    d = sharded_dim(spec, self.dp_entry)
                    if d is None:
                        full[key].append(t)
                        continue
                    f = torch.cat(self._all_gather(t), dim=d)
                    full[key].append(f)
                    cuts.append((t, f, _slicer(local_slices(
                        f.shape, spec, self.mesh))))
            adafactor_group([ps[i] for i in idx], [gs[i] for i in idx],
                            full["vr"], full["vc"], consts, self.tcfg,
                            stacked=stacked)
            with torch.no_grad():
                for t, f, sl in cuts:
                    t.copy_(f[sl])
