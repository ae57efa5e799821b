"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 — encoder-decoder, multimodal. [arXiv:2308.11596; hf]

The speech frontend (fbank conv feature extractor) is a stub: requests
carry precomputed frame embeddings (T_enc, d_model). Encoder frames are
capped at the model's 4k operating envelope.
"""

from repro_torch.configs.base import ModelConfig, SWMConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                 # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    enc_seq=4096,                # frontend envelope cap
    tie_embeddings=True,
    swm=SWMConfig(block_size=128, impl="paper"),
    remat="block",
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    enc_seq=16,
    swm=SWMConfig(block_size=8, impl="paper"),
    remat="none",
    param_dtype="float32",
    compute_dtype="float32",
)
