"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) ff=7680.

RG-LRU + local attention, 1 attention : 2 recurrent pattern, 2048-token
window [arXiv:2402.19427; hf].  Sub-quadratic ⇒ runs long_500k.
26 = 8 scanned (rec, rec, local) groups + 2 trailing recurrent layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    block_pattern=("recurrent", "recurrent", "local"),
    window=2048,
    lru_width=2560,
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=5,  # one (rec,rec,local) group + 2 rest recurrents
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=256,
    block_pattern=("recurrent", "recurrent", "local"),
    window=16,
    lru_width=64,
    tie_embeddings=True,
    subquadratic=True,
    attn_chunk=32,
)
