"""recurrentgemma-9b [hybrid: RG-LRU + local attention, 2:1] —
arXiv:2402.19427 (Griffin; unverified tier).

38 layers cycling (rglru, rglru, attn); local attention window 2048,
MQA (kv=1), head_dim 256, lru width 4096.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,            # MQA
    d_head=256,
    d_ff=12288,
    vocab=256000,
    local_window=2048,
    layer_pattern=("rglru", "rglru", "attn"),
    rnn_width=4096,
    rglru_conv=4,
    rope_theta=10000.0,
    mlp_kind="swiglu",     # Griffin uses GeGLU; SwiGLU is the closest gated unit
    norm_kind="rmsnorm",
    scan_layers=False,     # heterogeneous pattern -> unrolled stack
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv=1,
    d_head=32,
    d_ff=256,
    vocab=256,
    local_window=32,
    layer_pattern=("rglru", "rglru", "attn"),
    rnn_width=128,
    rglru_conv=4,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    scan_layers=False,
)
