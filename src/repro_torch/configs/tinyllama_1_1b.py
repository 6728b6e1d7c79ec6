"""tinyllama-1.1b [dense, llama2-arch small] — arXiv:2401.02385 (hf-verified)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv=4,            # GQA
    d_ff=5632,
    vocab=32000,
    rope_theta=10000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="tinyllama-1.1b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv=1,
    d_ff=256,
    vocab=256,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
