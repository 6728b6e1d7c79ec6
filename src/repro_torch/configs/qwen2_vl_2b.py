"""qwen2-vl-2b [vlm backbone] — arXiv:2409.12191 (hf-verified).

Transformer backbone only (modality frontend is a stub per assignment:
``input_specs`` provides precomputed patch embeddings). M-RoPE with
sections (16, 24, 24) over (t, h, w) position ids; head_dim=128.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    qkv_bias=True,
    d_ff=8960,
    vocab=151936,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv=2,
    qkv_bias=True,
    d_ff=192,
    vocab=256,
    mrope_sections=(2, 3, 3),
    tie_embeddings=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
