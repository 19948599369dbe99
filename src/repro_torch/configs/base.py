"""Model architecture description for the PyTorch port.

The port's own copy of ``repro.configs.base.ModelConfig``: the same
fields, defaults, ``head_dim`` post-init and ``param_counts``, so a
config built here compares equal field by field with the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (pure data; consumed by repro_torch.models)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 ⇒ d_model // n_heads

    # layer-kind pattern, repeated cyclically over n_layers.
    #   "global"    full causal attention
    #   "local"     sliding-window causal attention (window)
    #   "recurrent" RG-LRU block
    #   "ssm"       Mamba-2 SSD block
    block_pattern: Tuple[str, ...] = ("global",)
    window: int = 0

    rope_theta: float = 10_000.0
    mlp: str = "swiglu"  # swiglu | gelu
    norm: str = "rms"  # rms | layer
    logit_softcap: float = 0.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    moe_pattern: Tuple[bool, ...] = ()
    d_ff_dense: int = 0  # FFN width of non-MoE layers (0 ⇒ d_ff)

    # SSM (mamba2)
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # RG-LRU (recurrentgemma)
    lru_width: int = 0

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_len: int = 1500

    # VLM (qwen2-vl)
    mrope_sections: Tuple[int, ...] = ()

    # numerics / structure
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    attn_chunk: int = 1024  # kv-chunked attention when seq > this
    q_chunk: int = 2048  # additionally q-chunk when seq ≥ 8·attn_chunk
    flash: bool = False
    remat_policy: str = "full"

    # Whether a 512k dense decode is feasible (sub-quadratic archs only).
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def layer_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def moe_at(self, layer_idx: int) -> bool:
        if not self.is_moe:
            return False
        if not self.moe_pattern:
            return True
        return self.moe_pattern[layer_idx % len(self.block_pattern)]

    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params) — active differs for MoE."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        H, Kv, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += d * V  # head
        per_layer_total = 0
        per_layer_active = 0
        for l in range(self.n_layers):
            kind = self.layer_kind(l)
            if kind in ("global", "local"):
                attn = d * H * Dh + 2 * d * Kv * Dh + H * Dh * d
                if self.moe_at(l):
                    mlp_t = self.n_experts * 3 * d * ff + d * self.n_experts
                    mlp_a = self.top_k * 3 * d * ff + d * self.n_experts
                    mlp_t += self.n_shared_experts * 3 * d * ff
                    mlp_a += self.n_shared_experts * 3 * d * ff
                elif self.mlp == "swiglu":
                    ffd = self.d_ff_dense or ff
                    mlp_t = mlp_a = 3 * d * ffd
                else:
                    ffd = self.d_ff_dense or ff
                    mlp_t = mlp_a = 2 * d * ffd
                per_layer_total += attn + mlp_t
                per_layer_active += attn + mlp_a
            elif kind == "recurrent":
                r = self.lru_width or d
                blk = 2 * d * r + 2 * r * r + r * d + 4 * r
                mlp = 3 * d * ff if self.mlp == "swiglu" else 2 * d * ff
                per_layer_total += blk + mlp
                per_layer_active += blk + mlp
            elif kind == "ssm":
                di = self.expand * d
                nh = di // self.ssm_head_dim
                in_p = d * (2 * di + 2 * self.d_state + nh)
                blk = in_p + self.d_conv * (di + 2 * self.d_state) + di * d
                per_layer_total += blk
                per_layer_active += blk
        total += per_layer_total
        active = V * d + (0 if self.tie_embeddings else d * V)
        active += per_layer_active
        if self.is_encdec:
            enc = self.n_enc_layers * (4 * d * H * Dh + 2 * d * ff)
            total += enc
            active += enc
        return total, active
