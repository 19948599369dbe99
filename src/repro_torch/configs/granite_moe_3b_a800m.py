"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) ff=512/expert,
V=49155, 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

The assignment line says both "MoE 40e" and "32 experts"; we follow the
shape-spec field (40 experts, top-8) — discrepancy noted in DESIGN.md.
Experts are small (ff=512) ⇒ expert FFN dim is tensor-parallel while the
expert axis stays replicated (40 ∤ 16).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49_155,
    n_experts=40,
    top_k=8,
    capacity_factor=1.25,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab=256,
    n_experts=8,
    top_k=2,
    capacity_factor=2.0,
    tie_embeddings=True,
    attn_chunk=32,
)
