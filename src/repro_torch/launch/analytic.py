"""Analytic roofline model: FLOPs / HBM bytes / collective bytes per cell.

Straight napkin math over the known model graph, every term auditable: the
count that a measured step time is held against (``launch.roofline``
divides it by the card's peak rates). Pure arithmetic on the port's
configs and ``core.circulant``'s ``swm_flops`` / ``dense_flops`` /
``valid_block_size``; the terms are the reference's
(``repro.launch.analytic``), term for term. ``cell_model(cfg, shape,
chips=1, dp=1, tp=1)`` is one card.

Conventions (global, one step):
  * matmul FLOPs = 2·m·n·k; SWM layer FLOPs via core.circulant.swm_flops.
  * training total = 3 × forward (backward = 2×fwd), ×(4/3) when remat
    recomputes the forward (cfg.remat != 'none').
  * bytes: parameter traffic + optimizer state r/w + inter-layer activation
    traffic + attention KV traffic. Elementwise fusion is assumed (only
    layer-boundary tensors hit HBM) — an optimistic-but-standard model.
  * collectives (per chip): ring all-reduce ≈ 2·N bytes on the wire per
    chip; all-gather ≈ N·(s-1)/s ≈ N.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig
from repro_torch.core.circulant import (dense_flops, swm_flops,
                                        valid_block_size)

__all__ = ["cell_model"]

BF16 = 2
F32 = 4


def _proj_flops(cfg: ModelConfig, tokens: int, m: int, n: int,
                family: str) -> float:
    """One projection (n -> m) applied to `tokens` rows."""
    if cfg.swm.applies_to(family):
        k = valid_block_size(cfg.swm.block_size, n, m)
        if k > 1:
            return swm_flops(tokens, m, n, k, impl=cfg.swm.impl)
    return dense_flops(tokens, m, n)


def _proj_bytes(cfg: ModelConfig, m: int, n: int, family: str) -> float:
    """Weight bytes of one projection (read once per step)."""
    if cfg.swm.applies_to(family):
        k = valid_block_size(cfg.swm.block_size, n, m)
        if k > 1:
            return m * n / k * BF16
    return m * n * BF16


def _layer_terms(cfg: ModelConfig, spec: LayerSpec, tokens: int,
                 s_q: int, s_kv: int, kind: str) -> Dict[str, float]:
    """FLOPs + weight bytes + KV traffic for one layer application."""
    d, hd = cfg.d_model, cfg.head_dim
    HQ, HKV = cfg.n_heads, cfg.n_kv_heads
    f = b = kvb = 0.0
    if spec.mixer in ("attn", "attn_local"):
        q_out, kv_out = HQ * hd, HKV * hd
        f += _proj_flops(cfg, tokens, q_out, d, "attn")
        f += 2 * _proj_flops(cfg, tokens, kv_out, d, "attn")
        f += _proj_flops(cfg, tokens, d, q_out, "attn")
        b += _proj_bytes(cfg, q_out, d, "attn") * 2 \
            + _proj_bytes(cfg, kv_out, d, "attn") * 2
        eff_kv = min(s_kv, cfg.sliding_window) \
            if (spec.mixer == "attn_local" and cfg.sliding_window) else s_kv
        causal_f = 0.5 if (kind != "decode" and s_q == s_kv) else 1.0
        f += 4 * tokens * eff_kv * HQ * hd * causal_f  # scores + values
        # KV cache traffic: decode reads the whole cache per step
        if kind == "decode":
            kvb += 2 * (tokens * eff_kv) * HKV * hd * BF16
        else:
            kvb += 2 * tokens * HKV * hd * BF16        # write-once
    elif spec.mixer == "mamba":
        di, ds = cfg.mamba_expand * d, cfg.mamba_d_state
        dtr = cfg.mamba_dt_rank or max(1, d // 16)
        f += _proj_flops(cfg, tokens, 2 * di, d, "ffn")
        f += _proj_flops(cfg, tokens, d, di, "ffn")
        f += dense_flops(tokens, dtr + 2 * ds, di)
        f += dense_flops(tokens, di, dtr)
        f += tokens * di * (2 * cfg.mamba_d_conv + 6 * ds)   # conv + scan
        b += _proj_bytes(cfg, 2 * di, d, "ffn") + _proj_bytes(cfg, d, di, "ffn")
        kvb += 0 if kind != "decode" else tokens * di * ds * F32 * 2
    elif spec.mixer == "rwkv":
        f += 5 * _proj_flops(cfg, tokens, d, d, "attn")      # r,k,v,g,o
        f += tokens * (d * cfg.rwkv_decay_lora * 2 + d * cfg.rwkv_mix_lora * 10)
        H = d // cfg.rwkv_head_dim
        f += tokens * H * cfg.rwkv_head_dim ** 2 * 6          # wkv update
        b += 5 * _proj_bytes(cfg, d, d, "attn")
        kvb += 0 if kind != "decode" else \
            tokens * H * cfg.rwkv_head_dim ** 2 * F32 * 2

    # ffn
    if spec.mixer == "rwkv":
        f += _proj_flops(cfg, tokens, cfg.d_ff, d, "ffn")
        f += _proj_flops(cfg, tokens, d, d, "ffn")
        f += _proj_flops(cfg, tokens, d, cfg.d_ff, "ffn")
        b += (_proj_bytes(cfg, cfg.d_ff, d, "ffn")
              + _proj_bytes(cfg, d, d, "ffn")
              + _proj_bytes(cfg, d, cfg.d_ff, "ffn"))
    else:
        if spec.ffn in ("dense", "dense+moe"):
            f += 2 * _proj_flops(cfg, tokens, cfg.d_ff, d, "ffn")
            f += _proj_flops(cfg, tokens, d, cfg.d_ff, "ffn")
            b += 2 * _proj_bytes(cfg, cfg.d_ff, d, "ffn") \
                + _proj_bytes(cfg, d, cfg.d_ff, "ffn")
        if spec.ffn in ("moe", "dense+moe"):
            E, T = cfg.n_experts, cfg.n_experts_per_token
            dff = cfg.d_ff_expert or cfg.d_ff
            cap_tokens = tokens * T * cfg.capacity_factor
            f += dense_flops(tokens, E, d)                    # router
            f += 2 * _proj_flops(cfg, int(cap_tokens), dff, d, "expert")
            f += _proj_flops(cfg, int(cap_tokens), d, dff, "expert")
            b += E * (2 * _proj_bytes(cfg, dff, d, "expert")
                      + _proj_bytes(cfg, d, dff, "expert"))
    return {"flops": f, "wbytes": b, "kvbytes": kvb}


def cell_model(cfg: ModelConfig, shape: ShapeConfig, chips: int = 256,
               dp: int = 16, tp: int = 16) -> Dict[str, float]:
    """Global analytic terms for one (arch × shape) cell."""
    kind = shape.kind
    if kind == "decode":
        tokens = shape.global_batch              # one token per sequence
        s_q, s_kv = 1, shape.seq_len
    else:
        tokens = shape.global_batch * shape.seq_len
        s_q = s_kv = shape.seq_len

    enc_tokens = 0
    if cfg.family == "encdec":
        enc = min(shape.seq_len, cfg.enc_seq or shape.seq_len)
        enc_tokens = shape.global_batch * enc

    flops = wbytes = kvbytes = 0.0
    for group in cfg.layer_groups():
        for spec in group.layers:
            t = _layer_terms(cfg, spec, tokens, s_q, s_kv, kind)
            flops += t["flops"] * group.repeat
            wbytes += t["wbytes"] * group.repeat
            kvbytes += t["kvbytes"] * group.repeat
    if cfg.family == "encdec":
        ne = cfg.n_enc_layers or cfg.n_layers
        enc_len = min(shape.seq_len, cfg.enc_seq or shape.seq_len)
        if kind != "decode":
            # encoder stack over the frame sequence (bidirectional)
            t = _layer_terms(cfg, LayerSpec(mixer="attn", ffn="dense"),
                             enc_tokens, enc_len, enc_len, "prefill")
            flops += t["flops"] * ne
            wbytes += t["wbytes"] * ne
        # decoder cross-attention: q/o projections + attend over enc KV
        d, hd, HQ, HKV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        xf = (_proj_flops(cfg, tokens, HQ * hd, d, "attn")
              + _proj_flops(cfg, tokens, d, HQ * hd, "attn")
              + 4 * tokens * enc_len * HQ * hd)
        flops += xf * cfg.n_layers
        wbytes += 2 * _proj_bytes(cfg, HQ * hd, d, "attn") * cfg.n_layers
        if kind == "decode":
            kvbytes += 2 * tokens * enc_len * HKV * hd * BF16 * cfg.n_layers

    # vocab head
    head_tokens = tokens if kind == "train" else shape.global_batch
    flops += 2 * head_tokens * cfg.d_model * cfg.vocab
    wbytes += cfg.vocab * cfg.d_model * BF16

    # ---- per-chip totals ------------------------------------------------
    # Weights are TP-sharded only: every DP replica streams its model shard
    # each step (FSDP shards further but all-gathers back per microbatch).
    # Activations / KV / optimizer state divide by the full chip count
    # (batch over DP, heads/experts over TP, ZeRO-1 moments over DP).
    mb = 8 if kind == "train" else 1                 # production microbatches
    if kind == "train":
        remat_mult = 4.0 if cfg.remat != "none" else 3.0
        flops_total = flops * remat_mult            # fwd + 2×bwd (+ remat fwd)
        from repro_torch.launch.specs import count_params
        n = count_params(cfg)["stored"]
        # params+grads+opt traffic: p read(bf16)+write + grad f32 + m,v r/w
        opt_bytes_chip = n * (2 * BF16 + F32 + 4 * F32) / chips
        w_chip = (wbytes / tp) * 3.0                 # fwd + remat-fwd + bwd
        act_chip = tokens * cfg.d_model * BF16 * cfg.n_layers * 3 / chips
        bytes_chip = w_chip + opt_bytes_chip + act_chip + kvbytes / chips
        # collectives per chip: grad ring all-reduce (f32, TP-sharded),
        # 2 TP all-reduces per layer on activations (fwd+bwd), MoE a2a,
        # FSDP param regather per microbatch
        grads_per_chip = n * F32 / tp
        tp_act = 2 * (tokens / dp) * cfg.d_model * BF16 * cfg.n_layers * 2
        coll = 2 * grads_per_chip + tp_act
        if cfg.is_moe:
            coll += 2 * (tokens / chips) * cfg.n_experts_per_token \
                * cfg.d_model * BF16 * (cfg.n_layers // cfg.moe_every) * 3
        if cfg.fsdp:
            coll += mb * n * BF16 / dp
    else:
        flops_total = flops
        w_chip = wbytes / tp
        act_chip = tokens * cfg.d_model * BF16 * cfg.n_layers * 2 / chips
        bytes_chip = w_chip + act_chip + kvbytes / chips
        tp_act = 2 * (tokens / max(dp, 1)) * cfg.d_model * BF16 * cfg.n_layers
        coll = tp_act
        if cfg.is_moe:
            coll += 2 * (tokens / chips) * cfg.n_experts_per_token \
                * cfg.d_model * BF16 * (cfg.n_layers // cfg.moe_every)

    # minimal unavoidable per-chip byte stream: weights once (TP shard) +
    # KV/state once — the memory-roofline ideal for serve cells
    min_bytes_chip = wbytes / tp + kvbytes / chips
    return {
        "a_flops": flops_total,
        "a_bytes": bytes_chip * chips,
        "a_coll_per_chip": coll,
        "a_flops_per_chip": flops_total / chips,
        "a_bytes_per_chip": bytes_chip,
        "a_min_bytes_per_chip": min_bytes_chip,
    }
