"""minicpm3-4b [dense, MLA] — hf:openbmb/MiniCPM3-4B (hf-verified).

MLA ranks from the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32. v_head_dim follows the nope dim
(64) as in the MiniCPM3 modeling code.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv=40,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    d_ff=6400,
    vocab=73448,
    rope_theta=10000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="minicpm3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv=4,
    attn_kind="mla",
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    d_ff=256,
    vocab=256,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
)
