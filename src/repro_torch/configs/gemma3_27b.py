"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-*; unverified]"""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="lm",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    sliding_window=1024,
    local_global_pattern=5,           # 5 local : 1 global
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    tie_embeddings=True,
    swm=SWMConfig(block_size=128, impl="paper"),
    fsdp=False,
    remat="block",
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="lm",
    n_layers=6,                       # one full 5:1 period
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    head_dim=24,
    d_ff=192,
    vocab=256,
    sliding_window=8,
    local_global_pattern=5,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
