"""The train step: loss (chunked CE + z-loss + MoE aux), grad
accumulation (microbatching), global-norm clip, AdamW or Adafactor.

The state is the reference's dict ``{"params", "opt", "step"}``. Its param
leaves are the model's own buffers, made leaf tensors that require grad by
:func:`init_train_state`; a step takes grads with ``torch.autograd.grad``
into a tree keyed like the params and updates params and moments in place
under ``torch.no_grad()``, so no step copies the model. ``step`` is a
Python int (the host computes the learning rate from it).

``tcfg.qat_bits > 0`` is quantization-aware training: every forward sees
fixed-point copies of the params (``core.quant.quantize_tree``, biases and
norm scales exempt), installed in the model for that forward, while the
grads are taken with respect to, and the optimizer updates, the
full-precision masters.

Every family the port serves trains here, as in the reference: ``lm``
(tokens), ``vlm`` (an optional ``img`` prefix, the loss on the text
positions only) and ``encdec`` (encoder ``frames``); the MoE layers'
experts carry their gradients through the grouped kernels.

Fault-tolerant restarts wrap this step from outside:
``ft.driver.TrainDriver`` checkpoints the state and, after a failed step,
copies the latest checkpoint back into the same tensors.

With ``mesh=`` (a ``DeviceMesh`` with data axes and a ``model`` axis:
``launch.mesh.make_local_mesh``, or any ``init_device_mesh`` with those
names) the step is parallel (:mod:`repro_torch.dist.data_parallel`):
each rank takes its batch shard, holds its params as its shard under the
rule table (the ``model`` axis's tensor-parallel rules; ``embed`` over
the data axes for an FSDP config), averages the grads over the data axes
with one bucketed all-reduce, and holds the optimizer moments as its
ZeRO-1 shard. The mesh also becomes the ambient mesh that
``impl="freq_shmap"`` reads. A model that tensor parallelism does not
cover (paligemma's vision prefix, FSDP of the enc-dec family) is refused
on a ``model`` axis > 1 and keeps whole params on a ``(world, 1)`` mesh.

``audit_args`` gates a step on its structural contract
(:mod:`repro_torch.analysis`): the step runs once, captured, on a clone of
the state, and a violation raises ``StructuralContractError`` with the
``file:line`` of each offending op.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.convert import layer_stacks
from repro_torch.core.quant import default_exempt, quantize_tree
from repro_torch.dist.sharding import local_slices
from repro_torch.nn.module import load_tree, tree_leaves, tree_map
from repro_torch.optim.optimizers import (adafactor_init, adafactor_update,
                                          adamw_init, adamw_update,
                                          clip_by_global_norm)
from repro_torch.train.losses import chunked_cross_entropy

__all__ = ["make_loss_fn", "make_train_step", "init_train_state",
           "make_grad_step", "value_and_grad"]


def _audit_step(step_fn, audit_args, rules, name: str):
    """Run ``step_fn`` once, captured, on a clone of ``audit_args``' first
    element (the state or the params: all its tensors are weight data) and
    the batch; raise ``StructuralContractError`` (its ``trace`` the
    capture) on any violation of ``rules``, else return the capture."""
    from repro_torch.analysis.contracts import (Contract,
                                                StructuralContractError,
                                                clone_tree, run_contract)
    from repro_torch.analysis.walker import Trace, capture

    state, *rest = audit_args
    state = clone_tree(state)
    # the ops only: the step's result is the clone, which is let go
    trace = Trace(capture(step_fn, state, *rest, pure=state).ops)
    violations = run_contract(Contract(name=name, rules=tuple(rules)), trace)
    if violations:
        raise StructuralContractError(violations, trace=trace)
    return trace


def value_and_grad(fn: Callable, params, batch, *, has_aux: bool = False):
    """``fn(params, batch)`` and its gradient with respect to every param
    leaf (each a leaf tensor that requires grad), as a tree keyed like
    ``params``. Returns (value, grads) or ((value, aux), grads)."""
    out = fn(params, batch)
    loss = out[0] if has_aux else out
    leaves = tree_leaves(params)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    gtree = tree_map(lambda p: _or_zeros(next(grads), p), params)
    if has_aux:
        return (loss.detach(), tree_map(torch.Tensor.detach, out[1])), gtree
    return loss.detach(), gtree


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def make_grad_step(loss_fn: Callable, lr: float = 0.1, audit_args=None,
                   audit_rules=None):
    """Minimal SGD step over a bare ``loss_fn(params, batch)`` (no
    optimizer state): ``p -= lr * g`` in the param's dtype, in place.
    Returns ``step(params, batch) -> (params, loss)``.

    ``audit_args=(params, batch)`` gates the step on the train-step
    structural contract before it returns: the step runs once, captured,
    on a clone of the params (``step.audit_trace`` keeps the capture), and
    any violation raises ``StructuralContractError`` with ``file:line``.
    ``audit_rules``
    overrides the rules (default ``NoFFT`` + ``NoDenseDotGeneral``, right
    for plan-path losses, whose adjoint must stay in the kernels)."""

    def step(params, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.sub_(lr * g.to(p.dtype))
        return params, loss

    step.audit_trace = None
    if audit_args is not None:
        from repro_torch.analysis.rules import NoDenseDotGeneral, NoFFT

        rules = (audit_rules if audit_rules is not None
                 else (NoFFT(), NoDenseDotGeneral()))
        step.audit_trace = _audit_step(step, audit_args, rules,
                                       name="grad_step")
    return step


def make_loss_fn(model, cfg: ModelConfig, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (loss, metrics)``. Batch layouts, as the
    reference's:

    - lm: ``{"tokens": (B, S+1)}``;
    - vlm: ``{"tokens": (B, S+1), "img": (B, P, D)}`` (``img`` optional);
    - encdec: ``{"frames": (B, T, D), "tokens": (B, S+1)}``.

    Installs ``params`` in ``model`` (the same tensors, no copies), runs it
    to its final hidden states (a vlm's cut to the text positions after its
    ``img`` prefix) and takes the chunked cross-entropy against the output
    table. With ``tcfg.qat_bits`` it installs ``quantize_tree(params,
    qat_bits, qat_frac)`` instead (``qat_frac_bits < 0`` means ``qat_bits -
    4``): tensors computed from the masters, so the gradient flows back to
    them through the clipped straight-through estimator."""
    qat_bits = int(tcfg.qat_bits or 0)
    qat_frac = int(tcfg.qat_frac_bits)
    if qat_frac < 0:
        qat_frac = qat_bits - 4

    def loss_fn(params, batch):
        if qat_bits:
            params = quantize_tree(params, qat_bits, qat_frac,
                                   exempt=default_exempt)
        load_tree(model, params)
        tokens = batch["tokens"]
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        kwargs = {}
        img = batch.get("img") if cfg.family == "vlm" else None
        if img is not None:
            kwargs["img_embeds"] = img
        if cfg.family == "encdec":
            if "frames" not in batch:
                raise KeyError(
                    f"{cfg.name!r} is an encoder-decoder model: its batches "
                    f"carry 'frames' (B, T, d_model) beside 'tokens'")
            kwargs["frames"] = batch["frames"]
        hidden, aux = model.forward_hidden(inp, **kwargs)
        if img is not None:
            hidden = hidden[:, img.shape[1]:]            # loss on text only
        ce, metrics = chunked_cross_entropy(
            hidden, model.output_table(), labels, z_loss=tcfg.z_loss,
            vocab_shard=getattr(model, "vocab_shard", None))
        loss = ce + tcfg.moe_aux_loss * aux
        return loss, {"ce": ce, "aux": aux, **metrics}

    return loss_fn


def init_train_state(params, tcfg: TrainConfig, optimizer: str = "adamw",
                     opt_shardings=None, mesh=None, stacks=(),
                     param_shardings=None):
    """``{"params", "opt", "step": 0}``. Every param leaf becomes a leaf
    tensor that requires grad, in place (the tree keeps its tensors).
    With ``param_shardings`` (the ``"params"`` subtree of the parallel
    step's ``state_shardings``) and ``mesh``, ``params`` is the whole tree
    and each leaf is cut to this rank's shard
    (``dist.sharding.local_shard``: a copy where it is split); with
    ``opt_shardings`` (the ``"opt"`` subtree) and ``mesh``, each moment is
    made as this rank's shard only. Adafactor's moments take ``stacks``
    (``convert.layer_stacks(cfg)``, the stacks the step updates as one
    leaf each; :mod:`repro_torch.optim.optimizers`)."""
    # the moments' shapes at no allocation, from the whole params
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
    if param_shardings is not None:
        from repro_torch.dist.sharding import local_shard

        params = tree_map(lambda p, spec: local_shard(p.detach(), spec, mesh),
                          params, param_shardings)
    for p in tree_leaves(params):
        if not p.is_leaf:
            raise ValueError("param leaves must be leaf tensors (no grad "
                             "history); detach them first")
        p.requires_grad_(True)
    if optimizer == "adafactor":
        init = functools.partial(adafactor_init, stacks=stacks)
    else:
        init = adamw_init
    if opt_shardings is None:
        return {"params": params, "opt": init(params, tcfg), "step": 0}
    # zeros of the local shape
    dev = tree_leaves(params)[0].device
    opt = {}
    for key, tree in init(meta, tcfg).items():
        opt[key] = tree_map(
            lambda t, spec: torch.zeros(
                [b - a for a, b in local_slices(t.shape, spec, mesh)],
                dtype=t.dtype, device=dev), tree, opt_shardings[key])
    return {"params": params, "opt": opt, "step": 0}


def make_train_step(model, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    audit_args=None, audit_rules=None):
    """``train_step(state, batch) -> (state, metrics)``: grads (averaged
    over ``tcfg.microbatch`` equal slices of the batch when > 1; a batch
    that ``microbatch`` does not divide raises ``ValueError``), global-norm
    clip, then AdamW or Adafactor by ``cfg.optimizer``; the state is
    updated in place and returned.

    With ``mesh`` the step is parallel over it (module docstring; the
    model's modules take this rank's shares, so the model then runs as
    this rank's part); the batch it takes is the global one, the same on
    every rank, and the state's params and moments must be this rank's
    shards, as ``init_train_state(param_shardings=..., opt_shardings=
    ..., mesh=mesh)`` makes them from ``train_step.data_parallel
    .state_shardings`` (whole leaves raise ``ValueError``).
    ``train_step.data_parallel`` is the
    :class:`~repro_torch.dist.data_parallel.DataParallel` (its
    ``collectives`` and ``comm_bytes`` counters included), None without a
    mesh.

    ``audit_args=(state, batch)`` audits the step before it returns: one
    step, captured, on a clone of the state (``train_step.audit_trace``
    keeps the capture). The default rules are the
    reference's: an SWM config gets ``DenseFallbackDot`` (no contraction
    against a circulant layer's dense-equivalent kernel; state-derived
    operands only, so activations pass) and a kernel- or DFT-backed impl
    also ``NoFFT``. The ``paper``/``freq`` impls transform the weights
    every forward in training by design (freezing happens at serve), so
    no weight-fft rule applies. ``audit_rules`` overrides them."""
    loss_fn = make_loss_fn(model, cfg, tcfg)
    dp = None
    if mesh is not None:
        from repro_torch.dist.data_parallel import DataParallel
        from repro_torch.dist.sharding import set_ambient_mesh

        dp = DataParallel(mesh, model, cfg, tcfg)
        set_ambient_mesh(mesh)

    def compute_grads(params, batch):
        n = tcfg.microbatch
        if n and n > 1:
            B = next(iter(batch.values())).shape[0]
            if B % n:
                # the reference reshapes to (n, B // n, ...) and refuses
                # too: unequal slices weighted 1/n would skew the gradient
                raise ValueError(f"batch {B} does not split into "
                                 f"microbatch={n} equal slices")
            micro = [{k: v.reshape(n, B // n, *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(n)]
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss, metrics = 0.0, []
            for mb in micro:
                (l, m), grads = value_and_grad(loss_fn, params, mb,
                                               has_aux=True)
                with torch.no_grad():
                    for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                        a.add_(g.float() / n)
                loss = loss + l / n
                metrics.append(m)
            # metrics averaged over the microbatches, as the loss is
            mean = tree_map(lambda *ms: torch.stack(ms).mean(0), *metrics)
            return loss, mean, acc
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                has_aux=True)
        return loss, metrics, grads

    if cfg.optimizer == "adafactor":
        update = functools.partial(adafactor_update,
                                   stacks=layer_stacks(cfg))
    else:
        update = adamw_update

    def train_step(state, batch):
        routing = contextlib.nullcontext()
        if dp is not None:
            dp.check_shards(state)
            local = dp.local_batch(batch)
            routing = dp.routing(batch, local)
            batch = local
        with routing:
            loss, metrics, grads = compute_grads(state["params"], batch)
        if dp is not None:
            grads, loss, metrics = dp.average(grads, loss, metrics)
        # the norm is taken leaf by leaf, after the average, in the same
        # order with or without a mesh
        grads, gnorm = clip_by_global_norm(
            grads, tcfg.grad_clip, **(dp.norm_args() if dp else {}))
        if dp is not None:
            dp.update(state["params"], grads, state["opt"], state["step"])
        else:
            update(state["params"], grads, state["opt"], state["step"], tcfg)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, **metrics}

    train_step.data_parallel = dp
    train_step.audit_trace = None
    if audit_args is not None:
        rules = audit_rules
        if rules is None:
            from repro_torch.analysis.contracts import (
                FFT_FREE_IMPLS, dense_equivalent_shapes)
            from repro_torch.analysis.rules import DenseFallbackDot, NoFFT

            rules = []
            if cfg.swm.enabled:
                rules.append(DenseFallbackDot(
                    dense_equivalent_shapes(model.specs()),
                    weight_side=True))
                if cfg.swm.impl in FFT_FREE_IMPLS:
                    rules.append(NoFFT())
        if rules:
            try:
                train_step.audit_trace = _audit_step(
                    train_step, audit_args, rules, name="train_step")
            finally:
                # the model holds the clone's stepped params: give it back
                # the caller's, violations or not
                load_tree(model, audit_args[0]["params"])
    return train_step
