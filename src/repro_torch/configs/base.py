"""Config dataclasses: models, SWM compression, input shapes, training.

The port's own copy of ``repro.configs.base``: the same fields and
defaults, so a config means the same model and the same training run in
both packages, with dtypes resolved to ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["SWMConfig", "LayerSpec", "LayerGroup", "ModelConfig",
           "ShapeConfig", "SHAPES", "TrainConfig", "torch_dtype"]


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"``/... (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# SWM (the paper's technique)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SWMConfig:
    """Block-circulant compression settings (paper §3/§4).

    block_size: k. 0 or 1 disables (dense baseline).
    impl: 'paper' | 'freq' | 'dft' | 'pallas' (see core.circulant). In
      the port 'pallas' names the hand-written CUDA kernel path, which
      replaces the reference's Pallas TPU kernel; 'dft' runs the transforms
      as dense matmuls in stock torch ops. 'freq_shmap' is 'freq' on the
      rank's own batch rows (the reference shards the transforms over the
      mesh's data axes; each data-parallel rank here holds only its rows).
    karatsuba: the 'dft' impl's complex contraction in 3 real einsums
      instead of 4; other impls ignore it.
    targets: which projection families are compressed.
    """

    block_size: int = 0
    impl: str = "freq"
    karatsuba: bool = False
    targets: Tuple[str, ...] = ("attn", "ffn", "expert")

    @property
    def enabled(self) -> bool:
        return self.block_size > 1

    def applies_to(self, family: str) -> bool:
        return self.enabled and family in self.targets


# ---------------------------------------------------------------------------
# Layer pattern descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One decoder layer's composition within a group.

    mixer: 'attn' | 'attn_local' | 'mamba' | 'rwkv'
    ffn:   'dense' | 'moe' | 'dense+moe' | 'none'
    """

    mixer: str = "attn"
    ffn: str = "dense"


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """``layers`` repeated ``repeat`` times (the reference stacks their
    params on a leading axis; the port keeps one module per layer)."""

    layers: Tuple[LayerSpec, ...]
    repeat: int


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "lm"          # lm | encdec | vlm
    # dims
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab: int = 256
    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    sliding_window: int = 0
    local_global_pattern: int = 0
    logit_softcap: float = 0.0
    flash_q_chunk: int = 512
    flash_kv_chunk: int = 1024
    # ffn / moe
    n_experts: int = 0
    n_experts_per_token: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1
    dense_residual_ffn: bool = False
    capacity_factor: float = 1.25
    # mamba (hybrid)
    attn_every: int = 0
    attn_offset: int = 0
    mamba_expand: int = 2
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0
    # rwkv
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32
    # encdec / vlm frontends
    n_enc_layers: int = 0
    enc_seq: int = 0
    n_img_tokens: int = 0
    tie_embeddings: bool = True
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_dtype: str = "float32"
    # compression
    swm: SWMConfig = dataclasses.field(default_factory=SWMConfig)
    # distribution / training knobs (read by later slices)
    fsdp: bool = False
    low_tp: bool = False
    remat: str = "block"
    scan_layers: bool = True
    optimizer: str = "adamw"
    groups: Optional[Tuple[LayerGroup, ...]] = None

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_groups(self) -> Tuple[LayerGroup, ...]:
        """Derive the group structure from the pattern fields."""
        if self.groups is not None:
            return self.groups
        specs = []
        for i in range(self.n_layers):
            if self.attn_every > 0:
                mixer = ("attn" if i % self.attn_every == self.attn_offset
                         else "mamba")
            elif self.local_global_pattern > 0:
                period = self.local_global_pattern + 1
                mixer = ("attn" if (i % period) == self.local_global_pattern
                         else "attn_local")
            elif self.sliding_window > 0:
                mixer = "attn_local"
            else:
                mixer = "attn"
            if self.is_moe and (i % self.moe_every == self.moe_every - 1):
                ffn = "dense+moe" if self.dense_residual_ffn else "moe"
            else:
                ffn = "dense"
            specs.append(LayerSpec(mixer=mixer, ffn=ffn))
        return _group_layers(tuple(specs))

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Per-layer specs in execution order (groups expanded)."""
        return tuple(lspec for g in self.layer_groups()
                     for _ in range(g.repeat) for lspec in g.layers)


def _group_layers(specs: Tuple[LayerSpec, ...]) -> Tuple[LayerGroup, ...]:
    """Factor the per-layer spec list into repeated groups: the smallest
    period P such that the sequence is (a prefix of) a repetition of its
    first P entries; a trailing partial period becomes its own group."""
    n = len(specs)
    for period in range(1, n + 1):
        pattern = specs[:period]
        if all(specs[i] == pattern[i % period] for i in range(n)):
            full, rem = divmod(n, period)
            groups = []
            if full:
                groups.append(LayerGroup(layers=pattern, repeat=full))
            if rem:
                groups.append(LayerGroup(layers=specs[full * period:],
                                         repeat=1))
            return tuple(groups)
    return (LayerGroup(layers=specs, repeat=1),)


# ---------------------------------------------------------------------------
# Input shapes (the assignment's 4 shapes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    moment_dtype: str = "float32"
    z_loss: float = 1e-4
    moe_aux_loss: float = 1e-2
    microbatch: int = 0                 # 0 = no gradient accumulation
    grad_compression: str = "none"      # none | int8_ef
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    # quantization-aware training: fake-quantize params through the clipped
    # STE every forward (0 = off). frac_bits -1 derives bits-4, matching the
    # paper's fixed-point split; biases/norm scales are exempt.
    qat_bits: int = 0
    qat_frac_bits: int = -1
