"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) ff=8960 V=151936.

M-RoPE (temporal/height/width sections) + dynamic resolution
[arXiv:2409.12191; hf].  The vision frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed patch embeddings and
3-D position ids; the backbone here is the full text decoder with
M-RoPE sections (16, 24, 24) over head_dim 128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151_936,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    mrope_sections=(2, 3, 3),
    tie_embeddings=True,
    attn_chunk=32,
)
