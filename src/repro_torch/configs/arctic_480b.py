"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual FFN in parallel.
[hf:Snowflake/snowflake-arctic-base; hf]

With the paper's SWM (k=128) the expert tables shrink 63x against bf16
dense experts (two f32 tables of K = 65 bins per 128 x 128 block: 520 B
against 32 KiB), so a 480B-parameter model's circulant tables fit one
device.
"""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="lm",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    n_experts_per_token=2,
    d_ff_expert=4864,
    moe_every=1,
    dense_residual_ffn=True,
    capacity_factor=1.25,
    rope_theta=10_000.0,
    tie_embeddings=False,
    swm=SWMConfig(block_size=128, impl="paper"),
    fsdp=True,
    remat="block",
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="lm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=256,
    n_experts=8,
    n_experts_per_token=2,
    d_ff_expert=96,
    dense_residual_ffn=True,
    tie_embeddings=False,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
