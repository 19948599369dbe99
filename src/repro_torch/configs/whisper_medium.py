"""whisper-medium [audio]: enc-dec, 24+24L d=1024 16H ff=4096 V=51865.

Encoder-decoder with conv frontend STUB [arXiv:2212.04356; unverified]:
``input_specs()`` provides precomputed 1500-frame embeddings (the output
of whisper's conv subsampling of 30 s of mel spectrogram).  The "24L"
assignment line is read as 24 encoder + 24 decoder layers (matching the
real whisper-medium).  Whisper is MHA (kv = heads) with GELU MLPs and
layernorm; learned positions are stood in by RoPE (noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,  # decoder layers
    n_enc_layers=24,
    enc_len=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51_865,
    mlp="gelu",
    norm="layer",
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    enc_len=30,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    mlp="gelu",
    norm="layer",
    attn_chunk=32,
)
