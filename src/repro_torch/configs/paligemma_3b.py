"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1, head_dim 256)
d_ff=16384 vocab=257216 — SigLIP frontend + gemma decoder.
[arXiv:2407.07726; hf]

The SigLIP vision tower is not modelled: callers pass precomputed patch
embeddings (B, 256, d_model) as ``img_embeds``; the decoder uses
prefix-LM masking (bidirectional over the image prefix, causal over text).
"""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    n_img_tokens=256,
    rope_theta=10_000.0,
    tie_embeddings=True,
    swm=SWMConfig(block_size=128, impl="paper"),
    remat="block",
)

SMOKE = ModelConfig(
    name="paligemma-smoke",
    family="vlm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=256,
    n_img_tokens=8,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
