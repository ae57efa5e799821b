"""Data and tensor parallelism for the train step: batch shards, one
bucketed grad all-reduce, ZeRO-1 optimizer moments, and params held as
this rank's shard under the rule table.

The mesh is a ``DeviceMesh`` with data axes (``data``, or ``pod`` and
``data``) and a ``model`` axis. Params are held as this rank's shard under
``dist.sharding.param_shardings`` (``state_shardings["params"]``): split
over ``model`` by the tensor-parallel rules, and over the data axes on
``embed`` for an FSDP config; ``dist.tensor_parallel.shard_model`` gives
the model's modules their shares, and the state is made so by
``train.loop.init_train_state(param_shardings=, opt_shardings=, mesh=)``.
A model that tensor parallelism does not cover
(``dist.tensor_parallel.refusal``: paligemma's vision prefix, FSDP
of the enc-dec family) is refused on a ``model`` axis > 1,
and on a ``(world, 1)`` mesh keeps its params whole on every rank, FSDP
configs too.

Each rank takes its data shard of each batch (the ranks of one ``model``
group take the same rows). After the backward, its grads, loss and
metrics are averaged over the data axes with ONE all-reduce of a
flattened f32 buffer (a bf16 grad round-trips f32 exactly, and a one-rank
mean is bit-for-bit the mesh-less grad); an FSDP leaf's grad comes
already summed over the data axes by its gather's reduce-scatter and is
only divided. The global norm of the clip counts each element once
(``tensor_parallel.norm_owner``), with one all-reduce over the world when
any leaf is sharded. Moments are held as this rank's shard under
``dist.sharding.opt_shardings`` (ZeRO-1, within the rank's param shard; a
step on whole moments raises): AdamW updates the matching slice of each
param shard, and the updated slices are all-gathered over the data axes,
one collective per param dtype. Adafactor's row and column means span a
whole leaf (a repeated layer group's whole stack): each rank adds its
shard's partial sums of g² into the group's whole moments, which are
small (a row and a column per leaf), with one all-reduce over the world,
and updates its param shard from them; no param, grad or moment is
gathered whole.

A MoE model routes its tokens over the global batch, as the reference
does (:meth:`DataParallel.routing`, ``nn.moe.global_routing``): one
all-gather of per-expert counts per MoE layer call, over the data axes.

On a ``gloo`` group, collectives of CUDA tensors are staged through host
memory (``dist.sharding``). ``collectives`` and ``comm_bytes`` count what
the step issued: its own collectives and those of the model's
tensor-parallel regions and FSDP gathers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.convert import layer_stacks
from repro_torch.dist.sharding import (CommLog, all_gather_list,
                                       all_reduce_flat, batch_pspec,
                                       data_axes, dp_size,
                                       local_slices, mesh_axis,
                                       opt_shardings, param_shardings,
                                       sharded_dim, _entry_axes)
from repro_torch.dist.tensor_parallel import (is_sharded, norm_owner,
                                              refusal, refuse_unsupported,
                                              shard_model)
from repro_torch.nn.module import map_specs, tree_leaves, tree_map
from repro_torch.optim.optimizers import (_EPS, adafactor_consts,
                                          adafactor_group,
                                          adafactor_groups,
                                          adafactor_state_specs, adamw_consts,
                                          adamw_leaf, adamw_state_specs)

__all__ = ["DataParallel"]


@contextlib.contextmanager
def _counted(dp, ctx):
    with ctx as route:
        try:
            yield route
        finally:
            if route is not None:
                dp.log.add(route.bytes, route.collectives,
                           kind="all-gather")


def _slicer(sl) -> tuple:
    return tuple(slice(a, b) for a, b in sl)


def _shape(sl) -> tuple:
    return tuple(b - a for a, b in sl)


class DataParallel:
    """The parallel half of one train step on ``mesh`` for ``model``.

    ``cfg.optimizer`` picks the moment specs (``adamw``: ``m``/``v``;
    ``adafactor``: ``vr``/``vc``). ``state_shardings`` is the layout the
    state is held in (params under the rule table, or whole for a model
    :func:`~repro_torch.dist.tensor_parallel.refusal` names; ZeRO-1
    moments), the tree ``init_train_state``, ``ft.TrainDriver`` and
    ``restore_checkpoint`` take; ``collectives`` / ``comm_bytes`` count
    the collectives issued so far and the bytes one rank sent in them."""

    def __init__(self, mesh, model, cfg, tcfg):
        refuse_unsupported(model, mesh)
        if not hasattr(mesh, "get_coordinate"):
            raise TypeError("data-parallel training needs a DeviceMesh "
                            "(launch.mesh.make_local_mesh); an abstract mesh "
                            "description holds no devices")
        self.mesh, self.cfg, self.tcfg = mesh, cfg, tcfg
        self.log = CommLog()
        dp = data_axes(mesh)
        self.dp_entry = (dp if len(dp) > 1 else dp[0]) if dp else None
        self.world = dp_size(mesh)
        self.group = (mesh_axis(mesh, self.dp_entry, self.log).group
                      if dp else None)
        self.full_specs = model.specs()
        if refusal(model) is None:
            self.param_specs = param_shardings(
                mesh, self.full_specs, fsdp=cfg.fsdp, low_tp=cfg.low_tp)
            shard_model(model, mesh, self.param_specs, self.log)
        else:
            self.param_specs = map_specs(
                lambda path, s: (None,) * len(s.shape), self.full_specs)
        pspecs = tree_leaves(self.param_specs)
        dp_set = set(dp)
        # leaves sharded over the data axes (FSDP): their grads arrive
        # summed over the data ranks by their gather's reduce-scatter
        self.fsdp_leaf = [self.world > 1 and any(
            set(_entry_axes(e)) & dp_set for e in spec) for spec in pspecs]
        self.any_sharded = any(is_sharded(spec, mesh) for spec in pspecs)
        self.norm_owner = [norm_owner(spec, mesh) for spec in pspecs]
        self.adafactor = cfg.optimizer == "adafactor"
        self.stacks = layer_stacks(cfg) if self.adafactor else ()
        self.mom_specs = (adafactor_state_specs(self.full_specs, tcfg,
                                                self.stacks)
                          if self.adafactor
                          else adamw_state_specs(self.full_specs, tcfg))
        self.opt_specs = {
            k: opt_shardings(mesh, v, fsdp=cfg.fsdp, low_tp=cfg.low_tp)
            for k, v in self.mom_specs.items()}
        # leaf lists (tree_leaves order) of the specs the update reads
        self._full, self._pspecs = tree_leaves(self.full_specs), pspecs
        self._mfull = {k: tree_leaves(v) for k, v in self.mom_specs.items()}
        self._mspecs = {k: tree_leaves(v) for k, v in self.opt_specs.items()}
        self.state_shardings = {"params": self.param_specs,
                                "opt": self.opt_specs, "step": ()}

    @property
    def collectives(self) -> int:
        return self.log.collectives

    @property
    def comm_bytes(self) -> int:
        return self.log.bytes

    def _all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        self.log.add(t.numel() * t.element_size(), kind="all-gather")
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
        all-reduce of a flattened f32 buffer (an FSDP leaf's grad, summed
        already, is only divided); new tensors in each input's shape and
        dtype."""
        if self.group is None:            # a mesh without data axes
            return grads, loss, metrics
        leaves = tree_leaves(grads)
        mine = [g for g, f in zip(leaves, self.fsdp_leaf) if not f]
        parts = mine + [loss] + tree_leaves(metrics)
        self.log.add(4 * sum(t.numel() for t in parts), kind="all-reduce")
        it = iter(all_reduce_flat(parts, self.group, divisor=self.world))
        out = [(g.float() / self.world).to(g.dtype) if f else next(it)
               for g, f in zip(leaves, self.fsdp_leaf)]
        g = iter(out)
        g = tree_map(lambda _: next(g), grads)
        lo = next(it)
        return g, lo, tree_map(lambda _: next(it), metrics)

    def norm_args(self) -> dict:
        """``clip_by_global_norm``'s keywords on this mesh: with a sharded
        leaf, the leaves this rank counts and the sum over the world."""
        if not self.any_sharded:
            return {}

        def world_sum(t):
            self.log.add(4, kind="all-reduce")
            return all_reduce_flat([t], None)[0]

        return {"counted": self.norm_owner, "reduce": world_sum}

    def check_shards(self, state) -> None:
        """Raise unless every param and moment has this rank's shard
        shape, as ``init_train_state(param_shardings=, opt_shardings=,
        mesh=)`` makes them."""
        pairs = [("params", tree_leaves(state["params"]),
                  tree_leaves(self.full_specs),
                  tree_leaves(self.param_specs))]
        pairs += [(f"moment {key!r}", tree_leaves(state["opt"][key]),
                   tree_leaves(self.mom_specs[key]), tree_leaves(specs))
                  for key, specs in self.opt_specs.items()]
        for what, ts, fulls, specs in pairs:
            for t, full, spec in zip(ts, fulls, specs):
                want = _shape(local_slices(full.shape, spec, self.mesh))
                if tuple(t.shape) != want:
                    raise ValueError(
                        f"{what} leaf of shape {tuple(t.shape)} is not this "
                        f"rank's shard {want}: make the state with "
                        f"init_train_state(..., param_shardings="
                        f"step.data_parallel.state_shardings['params'], "
                        f"opt_shardings=step.data_parallel"
                        f".state_shardings['opt'], mesh=mesh)")

    def update(self, params, grads, opt, step: int) -> None:
        """The optimizer step on this rank's moment shards, then each
        param shard made whole over the data axes again."""
        if self.adafactor:
            self._adafactor(params, grads, opt, step)
            return
        consts = adamw_consts(step, self.tcfg)
        gathered: Dict[torch.dtype, list] = {}
        for p, g, m, v, mspec, pspec, full in zip(
                tree_leaves(params), tree_leaves(grads),
                tree_leaves(opt["m"]), tree_leaves(opt["v"]),
                tree_leaves(self.opt_specs["m"]),
                tree_leaves(self.param_specs), tree_leaves(self.full_specs)):
            d = (sharded_dim(mspec, self.dp_entry) if self.dp_entry
                 else None)
            if d is None or sharded_dim(pspec, self.dp_entry) == d:
                # whole moments, or an FSDP leaf: the moment is the shard
                adamw_leaf(p, g, m, v, consts, self.tcfg)
                continue
            # the moment's slice within this rank's param shard
            base = local_slices(full.shape, pspec, self.mesh)
            sl = _slicer((a - b0, b - b0) for (a, b), (b0, _) in zip(
                local_slices(full.shape, mspec, self.mesh), base))
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
        """Adafactor on this rank's shards, each group of
        ``adafactor_groups`` (a stack of per-layer leaves as one) as the
        reference updates it: a group that nothing shards as one process
        updates it, any other by :meth:`_adafactor_sharded`."""
        consts = adafactor_consts(step, self.tcfg)
        ps, gs = tree_leaves(params), tree_leaves(grads)
        moms = {k: tree_leaves(opt[k]) for k in ("vr", "vc")}
        for idx, stacked in adafactor_groups(params, self.stacks):
            if any(is_sharded(spec, self.mesh) for i in idx for spec in (
                    self._pspecs[i], self._mspecs["vr"][i],
                    self._mspecs["vc"][i])):
                self._adafactor_sharded(
                    self._units(idx, stacked, ps, gs, moms), consts)
            else:
                adafactor_group([ps[i] for i in idx], [gs[i] for i in idx],
                                [moms["vr"][i] for i in idx],
                                [moms["vc"][i] for i in idx], consts,
                                self.tcfg, stacked=stacked)

    def _units(self, idx, stacked, ps, gs, moms) -> list:
        """The group's tensors as :meth:`_adafactor_sharded` takes them:
        one :class:`_Unit` per leaf, or one for a stack of 0-d or 1-d
        per-layer leaves (factored or not across the layers)."""
        mesh, full = self.mesh, self._full
        pspecs, mfull, mspecs = self._pspecs, self._mfull, self._mspecs

        def part(k, i, at=None):
            spec = mspecs[k][i]
            if at is None:
                at = _slicer(local_slices(mfull[k][i].shape, spec, mesh))
            return moms[k][i], at, norm_owner(spec, mesh)

        if stacked and ps[idx[0]].dim() <= 1:
            i0, n = idx[0], len(idx)
            factored = ps[i0].dim() == 1
            vr = [part("vr", i, (slice(l, l + 1),))
                  for l, i in enumerate(idx)]
            vc = ((mfull["vc"][i0].shape, [part("vc", i0)],
                   [part("vc", i) for i in idx]) if factored else None)
            return [_Unit(
                torch.stack([gs[i].float() for i in idx]),
                (n,) + tuple(full[i0].shape),
                [(0, n)] + list(local_slices(full[i0].shape, pspecs[i0],
                                             mesh)),
                norm_owner(pspecs[i0], mesh), ((n,), vr, vr), vc,
                [(ps[i], l) for l, i in enumerate(idx)])]
        units = []
        for i in idx:
            shape = tuple(full[i].shape)
            vr = [part("vr", i)]
            vc = ((mfull["vc"][i].shape, [part("vc", i)], [part("vc", i)])
                  if len(shape) >= 2 else None)
            units.append(_Unit(
                gs[i].float(), shape,
                list(local_slices(shape, pspecs[i], mesh)),
                norm_owner(pspecs[i], mesh),
                (mfull["vr"][i].shape, vr, vr), vc, [(ps[i], ...)]))
        return units

    @torch.no_grad()
    def _adafactor_sharded(self, units, consts) -> None:
        """One group's update with no leaf gathered whole. The group's new
        moments are made whole on every rank by ONE all-reduce over the
        world, of a factored leaf's ``vr`` and ``vc`` (one entry per row
        and per column of the leaf) and an unfactored one's ``vr`` (a 0-d
        or 1-d leaf): into it each rank adds, at their places, its grad
        shard's row and column sums of g² and its moment shards'
        ``beta2 * v``, each element added by one rank (``norm_owner``).
        Each rank then updates its whole param shard from them; the update
        clip's RMS over the group takes one more all-reduce."""
        lr, beta2 = consts
        moments, bufs = [], []     # each unit's vr (and vc), whole buffers
        for u in units:
            g2 = u.g.square() + _EPS
            r = u.region
            vr = g2.new_zeros(u.vr[0])
            if u.vc is None:
                if u.own:
                    vr[_slicer(r)] += (1 - beta2) * g2
                moments.append(u.vr)
                bufs.append(vr)
                continue
            vc = g2.new_zeros(u.vc[0])
            if u.own:
                vr[_slicer(r[:-1])] += (1 - beta2) * g2.sum(-1) / u.shape[-1]
                vc[_slicer(r[:-2] + r[-1:])] += ((1 - beta2) * g2.sum(-2)
                                                 / u.shape[-2])
            moments += [u.vr, u.vc]
            bufs += [vr, vc]
        for (_, add, _), buf in zip(moments, bufs):
            for leaf, at, own in add:
                if own:
                    buf[at] += beta2 * leaf.reshape(buf[at].shape)
        self.log.add(4 * sum(b.numel() for b in bufs), kind="all-reduce")
        whole = iter(all_reduce_flat(bufs, None))
        news, upds = [], []
        square = units[0].g.new_zeros(())
        for u in units:
            r = u.region
            vr = next(whole)
            news.append(vr)
            if u.vc is None:
                denom = vr[_slicer(r)]
            else:
                vc = next(whole)
                news.append(vc)
                mean = torch.clamp(vr.mean(-1), min=_EPS)
                denom = (vr[_slicer(r[:-1])][..., :, None]
                         * vc[_slicer(r[:-2] + r[-1:])][..., None, :]
                         / mean[_slicer(r[:-2])][..., None, None])
            upds.append(u.g * torch.rsqrt(denom + _EPS))
            if u.own:
                square = square + upds[-1].square().sum()
        self.log.add(4, kind="all-reduce")
        square = all_reduce_flat([square], None)[0]
        n = sum(math.prod(u.shape) for u in units)
        scale = torch.clamp(torch.sqrt(square / n + _EPS), min=1.0)
        for u, upd in zip(units, upds):
            for p, at in u.params:
                p32 = p.float()
                p.copy_(p32 - lr * (upd[at] / scale
                                    + self.tcfg.weight_decay * p32))
        for (_, _, put), buf in zip(moments, news):
            for leaf, at, _ in put:
                leaf.copy_(buf[at].reshape(leaf.shape))


@dataclasses.dataclass
class _Unit:
    """One tensor of an Adafactor group as the sharded update sees it:
    this rank's f32 grad block ``g`` at ``region`` (a ``(start, stop)``
    per dim) of the whole ``shape``, added into sums by this rank when
    ``own``; ``vr`` and ``vc`` (None: unfactored): the whole moment's
    shape and the ``(leaf, index, own)`` parts added into it and written
    back from it; ``params``: each param shard with its index in
    ``g``."""

    g: torch.Tensor
    shape: tuple
    region: list
    own: bool
    vr: tuple
    vc: Optional[tuple]
    params: list
