"""musicgen-large [audio decoder] — arXiv:2306.05284 (hf-verified).

Decoder-only transformer over EnCodec tokens: 4 parallel codebooks of
vocab 2048 (summed embeddings in, 4 heads out). The EnCodec frontend is a
stub per assignment (``input_specs`` provides code streams). MHA (kv=32),
LayerNorm + GELU MLP (the original is a standard pre-LN transformer).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=32,           # MHA
    d_ff=8192,
    vocab=2048,
    n_codebooks=4,
    rope_theta=10000.0,
    mlp_kind="gelu",
    mlp_bias=True,
    norm_kind="layernorm",
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=64,
    n_codebooks=4,
    mlp_kind="gelu",
    mlp_bias=True,
    norm_kind="layernorm",
)
