"""Model construction, parameter counts, and the shape/dtype and sharding
stand-ins of every (arch x shape) cell.

Nothing here allocates: params and optimizer state come from ParamSpecs,
caches from ``init_cache`` on the ``meta`` device. A stand-in leaf is a
``(shape, dtype)`` pair (the reference's ``ShapeDtypeStruct``), a sharding
the per-dim spec tuple of :mod:`repro_torch.dist.sharding`. Trees are in
the port's layout: one entry per layer, no leading layer-stack dim.

Shape kind -> program:
  train_*    -> train_step(state, batch)
  prefill_*  -> prefill(tokens, cache[, frontend input])
  decode_* / long_* -> decode_step(tokens (B, 1), cache, pos)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.convert import layer_stacks
from repro_torch.dist.sharding import (axis_names, axis_size, batch_pspec,
                                       data_axes, dp_size, opt_shardings,
                                       param_shardings)
from repro_torch.models.decoder import HybridDecoderLM
from repro_torch.models.encdec import EncDecLM
from repro_torch.nn.module import _walk, map_specs
from repro_torch.optim.optimizers import (adafactor_state_specs,
                                          adamw_state_specs)

__all__ = ["batch_specs", "build_model", "count_params", "state_specs",
           "cache_sds", "cache_shardings", "input_specs"]


def build_model(cfg: ModelConfig, device="cuda"):
    """The model for ``cfg`` on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``device="cpu"``, or ``"meta"``: shapes only, as
    the stand-ins below and the dry-run read them): :class:`EncDecLM` for
    the enc-dec family, :class:`HybridDecoderLM` otherwise. Tensors are
    installed afterwards with ``nn.module.load_tree``; the model itself
    holds none, and ``device`` is where it makes its caches."""
    cls = EncDecLM if cfg.family == "encdec" else HybridDecoderLM
    if torch.device(device).type != "meta":
        return cls(cfg, device=device)
    model = cls(cfg, device="cpu")
    model.device = torch.device("meta")
    return model


def count_params(cfg: ModelConfig) -> Dict[str, float]:
    """Stored, active and dense-equivalent parameter counts, read off the
    model's specs (bookkeeping: no tensor is made, on any device).

    * ``stored``: what the model holds (an SWM table is m·n/k);
    * ``*_active``: MoE experts scaled by top_k / E;
    * ``dense*``: the same model with SWM off, the compression denominator;
    * ``head_n`` / ``body_n`` / ``flops_n``: the FLOP-relevant split — the
      embedding gather costs ~0 FLOPs, the vocab projection one d×V matmul
      per logit position.
    """
    def counts(c: ModelConfig):
        model = build_model(c, device="meta")
        total = active = embed = 0
        frac = (c.n_experts_per_token / c.n_experts) if c.n_experts else 1.0
        for path, spec in _walk(model.specs()):
            n = int(np.prod(spec.shape))
            total += n
            in_moe = any("ffn_moe" in p or p == "experts" for p in path)
            active += n * (frac if in_moe else 1.0)
            if path[0] == "embed":
                embed += n
        return total, active, embed

    stored, stored_active, embed = counts(cfg)
    dense, dense_active, _ = counts(dataclasses.replace(
        cfg, swm=dataclasses.replace(cfg.swm, block_size=0)))
    head = cfg.d_model * cfg.vocab
    body = stored_active - embed - (0 if cfg.tie_embeddings else head)
    return {
        "stored": stored, "stored_active": stored_active,
        "dense": dense, "dense_active": dense_active,
        "embed": embed,
        "head_n": head,
        "body_n": max(body, 0),
        "flops_n": max(body, 0) + head,
        "compression": dense / max(stored, 1),
    }


def _sds(specs):
    return map_specs(lambda path, s: (s.shape, s.dtype), specs)


def state_specs(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    """(state stand-ins, state shardings) for the train step: params,
    the optimizer's moments (``cfg.optimizer``) and ``step``."""
    pspecs = build_model(cfg, device="meta").specs()
    opt = (adafactor_state_specs(pspecs, tcfg, layer_stacks(cfg))
           if cfg.optimizer == "adafactor"
           else adamw_state_specs(pspecs, tcfg))
    sds = {"params": _sds(pspecs),
           "opt": {k: _sds(v) for k, v in opt.items()},
           "step": ((), torch.int32)}
    shardings = {
        "params": param_shardings(mesh, pspecs, fsdp=cfg.fsdp,
                                  low_tp=cfg.low_tp),
        "opt": {k: opt_shardings(mesh, v, fsdp=cfg.fsdp, low_tp=cfg.low_tp)
                for k, v in opt.items()},
        "step": (),
    }
    return sds, shardings


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """A training batch's ``{name: (shape, dtype)}``: ``tokens`` (B, S+1)
    int32 (S+1 for next-token labels); a vlm's ``img`` (B, n_img_tokens,
    d_model) bf16; an enc-dec model's ``frames`` (B, min(S, enc_seq),
    d_model) bf16. With ``mesh``, (stand-ins, shardings), the batch dim
    over the data axes where they divide it."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S + 1), torch.int32)}
    if cfg.family == "vlm":
        specs["img"] = ((B, cfg.n_img_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = ((B, min(S, cfg.enc_seq or S), cfg.d_model),
                           torch.bfloat16)
    if mesh is None:
        return specs
    return specs, {k: batch_pspec(mesh, len(v[0]), batch=v[0][0])
                   for k, v in specs.items()}


def _map_cache(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_cache(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_cache(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def cache_sds(cfg: ModelConfig, batch: int, cache_len: int):
    """The cache of ``init_cache(batch, cache_len)`` as ``(shape, dtype)``
    leaves, read on the ``meta`` device (nothing is allocated): a list with
    one dict per decoder layer, or an enc-dec model's ``{"self": [...],
    "cross": [...]}``, slot axis 0 in every leaf."""
    cache = build_model(cfg, device="meta").init_cache(batch, cache_len)
    return _map_cache(lambda path, t: (tuple(t.shape), t.dtype), cache)


def _stack_of(cfg: ModelConfig):
    """path -> the leading stack dims the reference's cache leaf has there
    (its repeated groups and the enc-dec stacks are stacked on axis 0)."""
    if cfg.family == "encdec":
        return lambda path: (cfg.n_layers,)
    repeats = [g.repeat for g in cfg.layer_groups()
               for _ in range(g.repeat) for _ in g.layers]
    return lambda path: (repeats[path[0]],) if repeats[path[0]] > 1 else ()


def cache_shardings(cfg: ModelConfig, cache_tree, mesh):
    """Shard caches: batch over the data axes (when divisible), kv heads
    (and the other head/channel dims) over ``model``.

    The reference's rule runs on its stacked leaves: the data axes go to
    the first dim (of the first two) that is not 1 and that they divide,
    ``model`` to a later dim equal to a known head/channel size. The port
    runs the same rule on each leaf with the reference's stack dims in
    front, then drops them, so every dim gets the reference's entry. Where
    the reference puts the data axes on its layer stack (48 or 32 stacked
    layers on a 16-way data axis), the port's per-layer leaf keeps its
    batch dim unsharded, as the reference's is."""
    dp = data_axes(mesh)
    n_dp = dp_size(mesh)
    model_ok = "model" in axis_names(mesh)
    msize = axis_size(mesh, "model") if model_ok else 1
    model_dims = set()
    if cfg.n_kv_heads % max(msize, 1) == 0:
        model_dims.add(cfg.n_kv_heads)
    for d in (cfg.mamba_expand * cfg.d_model, cfg.d_ff, cfg.d_model,
              cfg.d_model // max(cfg.rwkv_head_dim, 1)):
        if d and d % max(msize, 1) == 0:
            model_dims.add(d)
    stack_of = _stack_of(cfg)

    def one(path, leaf):
        lead = stack_of(path[1:] if cfg.family == "encdec" else path)
        shape = lead + tuple(leaf[0])
        entries = [None] * len(shape)
        used_dp = used_model = False
        for i, d in enumerate(shape):
            if not used_dp and dp and d != 1 and d % n_dp == 0 and i <= 1:
                entries[i] = dp if len(dp) > 1 else dp[0]
                used_dp = True
                continue
            if (not used_model and model_ok and d in model_dims
                    and d % msize == 0 and i >= 1):
                entries[i] = "model"
                used_model = True
        return tuple(entries[len(lead):])

    return _map_cache(one, cache_tree)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """Everything one cell needs, as stand-ins and shardings: the train
    state and batch for a ``train`` shape; params, cache, tokens (and a
    vlm's or enc-dec's frontend input, and a decode step's ``pos``) for
    a serving shape."""
    tcfg = tcfg or TrainConfig()
    out: Dict[str, Any] = {"kind": shape.kind}
    if shape.kind == "train":
        sds, sh = state_specs(cfg, tcfg, mesh)
        bsds, bsh = batch_specs(cfg, shape, mesh)
        out.update(state_sds=sds, state_shardings=sh,
                   batch_sds=bsds, batch_shardings=bsh)
        return out
    pspecs = build_model(cfg, device="meta").specs()
    out["params_sds"] = _sds(pspecs)
    out["params_shardings"] = param_shardings(mesh, pspecs, fsdp=False)
    B, S = shape.global_batch, shape.seq_len
    csds = cache_sds(cfg, B, S)
    out["cache_sds"] = csds
    out["cache_shardings"] = cache_shardings(cfg, csds, mesh)
    if shape.kind == "prefill":
        out["tokens_sds"] = ((B, S), torch.int32)
        out["tokens_shardings"] = batch_pspec(mesh, 2, batch=B)
        if cfg.family in ("vlm", "encdec"):
            n = (cfg.n_img_tokens if cfg.family == "vlm"
                 else min(S, cfg.enc_seq or S))
            out["extra_sds"] = ((B, n, cfg.d_model), torch.bfloat16)
            out["extra_shardings"] = batch_pspec(mesh, 3, batch=B)
        return out
    out["tokens_sds"] = ((B, 1), torch.int32)
    out["tokens_shardings"] = batch_pspec(mesh, 2, batch=B)
    out["pos_sds"] = ((B,), torch.int32)
    out["pos_shardings"] = batch_pspec(mesh, 1, batch=B)
    return out
