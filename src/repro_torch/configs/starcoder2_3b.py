"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) ff=12288 V=49152.

GQA + RoPE [arXiv:2402.19173; hf].  StarCoder2-3B uses a plain GELU MLP
and layernorm (GPT-lineage), reflected here.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    rope_theta=100_000.0,
    mlp="gelu",
    norm="layer",
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=256,
    mlp="gelu",
    norm="layer",
    attn_chunk=32,
)
