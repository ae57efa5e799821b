"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
Finch, data-dependent decay. [arXiv:2404.05892; hf]

O(1) recurrent state per layer."""

from repro_torch.configs.base import (LayerGroup, LayerSpec, ModelConfig,
                                      SWMConfig)

_RWKV_GROUPS = (
    LayerGroup(layers=(LayerSpec(mixer="rwkv", ffn="dense"),), repeat=32),
)

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="lm",
    n_layers=32,
    d_model=4096,
    n_heads=64,               # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    rwkv_mix_lora=32,
    tie_embeddings=False,
    groups=_RWKV_GROUPS,
    swm=SWMConfig(block_size=128, impl="paper"),
    remat="block",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="lm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    rwkv_head_dim=16,
    rwkv_decay_lora=8,
    rwkv_mix_lora=8,
    tie_embeddings=False,
    groups=(LayerGroup(layers=(LayerSpec(mixer="rwkv", ffn="dense"),),
                       repeat=3),),
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
