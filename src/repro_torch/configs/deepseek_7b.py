"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008
vocab=102400 — llama-arch. [arXiv:2401.02954; hf]"""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="lm",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
    rope_theta=10_000.0,
    tie_embeddings=False,
    swm=SWMConfig(block_size=128, impl="paper"),
    remat="block",
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="lm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=172,            # not divisible by 8: exercises valid_block_size
    vocab=256,
    rope_theta=10_000.0,
    tie_embeddings=False,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
