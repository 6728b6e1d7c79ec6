"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B (hf-verified).

24 layers, 60 routed experts (top-4, d_expert=1408) + 4 shared experts
(4 x 1408 = 5632 fused shared width), GQA kv=16, QKV bias.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    qkv_bias=True,
    d_ff=1408,             # per-expert hidden (assignment: d_ff=1408)
    d_expert=1408,
    n_routed_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_shared_expert=1408,
    vocab=151936,
    rope_theta=1000000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    qkv_bias=True,
    d_ff=96,
    d_expert=96,
    n_routed_experts=8,
    top_k=2,
    n_shared_experts=2,
    d_shared_expert=96,
    vocab=256,
    moe_subgroup=64,
    capacity_factor=4.0,   # dropless at smoke scale (cf >= E/k)
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
