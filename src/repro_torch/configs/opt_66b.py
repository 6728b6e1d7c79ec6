"""OPT-66B — the paper's own evaluation model (arXiv:2205.01068)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="opt-66b",
    family="dense",
    n_layers=64,
    d_model=9216,
    n_heads=72,
    n_kv=72,
    d_ff=36864,
    vocab=50272,
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm_kind="layernorm",
)

SMOKE = ModelConfig(
    name="opt-66b-smoke",
    family="dense",
    n_layers=2,
    d_model=144,
    n_heads=8,
    n_kv=8,
    d_ff=576,
    vocab=256,
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm_kind="layernorm",
)
