"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
MoE 16 experts top-2 every 2 layers, Mamba:attention 7:1 interleave
(attention at layer offset 4 of each 8-layer block). [arXiv:2403.19887; hf]

Mamba layers carry O(1) state; only 4/32 layers hold KV caches."""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="lm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    n_experts_per_token=2,
    d_ff_expert=14336,
    moe_every=2,
    attn_every=8,
    attn_offset=4,
    mamba_expand=2,
    mamba_d_state=16,
    mamba_d_conv=4,
    capacity_factor=1.25,
    rope_theta=10_000.0,          # jamba uses no rope; retained for the bench
    tie_embeddings=False,
    swm=SWMConfig(block_size=128, impl="paper"),
    fsdp=True,
    remat="block",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="lm",
    n_layers=8,                   # one full mamba/attn/moe period
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    n_experts=4,
    n_experts_per_token=2,
    d_ff_expert=128,
    moe_every=2,
    attn_every=8,
    attn_offset=4,
    mamba_d_state=8,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
