"""deepseek-coder-33b [dense, llama-arch] — arXiv:2401.14196 (hf-verified)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv=8,            # GQA
    d_ff=19200,
    vocab=32256,
    rope_theta=100000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv=2,
    d_ff=256,
    vocab=256,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
