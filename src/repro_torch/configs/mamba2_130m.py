"""mamba2-130m [ssm, attention-free] — arXiv:2405.21060 (SSD; unverified tier).

24 layers, d_model=768, d_inner=1536 (expand 2), 24 SSD heads of dim 64,
state n=128, conv 4, no MLP sub-blocks (d_ff=0), vocab 50280.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    d_ff=0,
    vocab=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv=4,
    ssm_chunk=16,
    tie_embeddings=True,
    norm_kind="rmsnorm",
)
