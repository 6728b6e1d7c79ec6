"""OPT-175B — the paper's largest evaluation model (arXiv:2205.01068)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="opt-175b",
    family="dense",
    n_layers=96,
    d_model=12288,
    n_heads=96,
    n_kv=96,
    d_ff=49152,
    vocab=50272,
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm_kind="layernorm",
)

SMOKE = ModelConfig(
    name="opt-175b-smoke",
    family="dense",
    n_layers=2,
    d_model=192,
    n_heads=8,
    n_kv=8,
    d_ff=768,
    vocab=256,
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm_kind="layernorm",
)
