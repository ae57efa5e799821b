"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-235B-A22B; hf]"""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="lm",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    qk_norm=True,
    n_experts=128,
    n_experts_per_token=8,
    d_ff_expert=1536,
    moe_every=1,                 # every layer is MoE (no dense FFN)
    capacity_factor=1.25,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    swm=SWMConfig(block_size=128, impl="paper"),
    fsdp=True,
    remat="block",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="lm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=256,
    qk_norm=True,
    n_experts=8,
    n_experts_per_token=4,
    d_ff_expert=96,
    tie_embeddings=False,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
