"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B (hf-verified).

48 layers, 128 routed experts (top-8, d_expert=768), GQA kv=4 with
explicit head_dim=128 (q-dim 4096 > d_model 2048), no shared experts.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_head=128,
    d_ff=768,              # per-expert hidden (assignment: d_ff=768)
    d_expert=768,
    n_routed_experts=128,
    top_k=8,
    vocab=151936,
    rope_theta=1000000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_head=32,
    d_ff=96,
    d_expert=96,
    n_routed_experts=8,
    top_k=2,
    vocab=256,
    moe_subgroup=64,
    capacity_factor=4.0,   # dropless at smoke scale (cf >= E/k)
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
