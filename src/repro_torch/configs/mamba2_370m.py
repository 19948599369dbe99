"""mamba2-370m [ssm]: 48L d=1024 attn-free, d_state=128, V=50280.

SSD (state-space duality) [arXiv:2405.21060; unverified].
Sub-quadratic ⇒ runs long_500k.  d_inner = 2·d, headdim 64 ⇒ 32 heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,  # unused (attention-free)
    d_ff=0,
    vocab=50_280,
    block_pattern=("ssm",),
    d_state=128,
    expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    subquadratic=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab=256,
    block_pattern=("ssm",),
    d_state=16,
    expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    subquadratic=True,
    tie_embeddings=True,
)
