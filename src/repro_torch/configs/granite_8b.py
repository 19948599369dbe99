"""granite-8b [dense]: 36L d=4096 32H (GQA kv=8) ff=14336 V=49152.

Llama-architecture code model [arXiv:2405.04324; hf].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="granite-8b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=256,
    attn_chunk=32,
)
