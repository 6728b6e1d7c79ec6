"""OPT-30B — the paper's own evaluation model (arXiv:2205.01068).

48 layers, d_model 7168, 56 MHA heads, d_ff 4*d, vocab 50272, pre-LN
GELU transformer. (OPT uses learned positions; we use RoPE — a noted
deviation that does not affect the MatMul shapes the paper benchmarks.)
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="opt-30b",
    family="dense",
    n_layers=48,
    d_model=7168,
    n_heads=56,
    n_kv=56,
    d_ff=28672,
    vocab=50272,
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm_kind="layernorm",
)

SMOKE = ModelConfig(
    name="opt-30b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv=8,
    d_ff=512,
    vocab=256,
    mlp_kind="gelu",
    mlp_bias=True,
    qkv_bias=True,
    norm_kind="layernorm",
)
