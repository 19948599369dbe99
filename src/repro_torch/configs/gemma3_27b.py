"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) ff=21504 V=262144.

5:1 local:global attention pattern, 1024-token sliding window on local
layers, 128k context [hf:google/gemma-3-1b-pt; unverified].
62 = 10 scanned (5·local + 1·global) groups + 2 trailing local layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262_144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-27b-smoke",
    family="dense",
    n_layers=8,  # one full 6-group + 2 rest layers — exercises both paths
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window=16,
    tie_embeddings=True,
    attn_chunk=32,
)
