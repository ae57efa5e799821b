"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-0.6B; hf]"""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="lm",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    swm=SWMConfig(block_size=128, impl="paper"),
    remat="block",
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="lm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qk_norm=True,
    rope_theta=1_000_000.0,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
