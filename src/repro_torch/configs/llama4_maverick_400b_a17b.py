"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) ff=8192,
V=202048, 128 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

The flagship scale config: 128-expert top-1 routing with one shared
expert, MoE interleaved every other layer (dense layers ff=16384), as in
Maverick — that interleaving is what lands total params at ~400B with
~17B active.  Experts shard 128/16 = 8-way over the model axis (EP).
Early-fusion multimodality enters through the same embedding stream
(frontend stubs, as with the VLM entry).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    rope_theta=500_000.0,
    block_pattern=("global", "global"),
    moe_pattern=(False, True),
    d_ff_dense=16_384,
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    capacity_factor=1.25,
    param_dtype="bfloat16",  # 400B: bf16 master + adafactor fits HBM
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab=256,
    block_pattern=("global", "global"),
    moe_pattern=(False, True),
    d_ff_dense=128,
    n_experts=8,
    top_k=1,
    n_shared_experts=1,
    capacity_factor=2.0,
    attn_chunk=32,
)
