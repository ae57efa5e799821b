"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. [arXiv:2403.17297; hf]"""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="lm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    swm=SWMConfig(block_size=128, impl="paper"),
    remat="block",
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="lm",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=256,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
