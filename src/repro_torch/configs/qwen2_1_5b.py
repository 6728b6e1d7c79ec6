"""qwen2-1.5b [dense, GQA + QKV bias] — arXiv:2407.10671 (hf-verified)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,            # GQA
    qkv_bias=True,
    d_ff=8960,
    vocab=151936,
    rope_theta=1000000.0,
    tie_embeddings=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv=1,
    qkv_bias=True,
    d_ff=192,
    vocab=256,
    tie_embeddings=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
