"""Model architecture description for the PyTorch port.

The port's own copies of ``repro.configs.base.ModelConfig`` and
``TrainConfig``: the same fields, defaults, ``head_dim`` post-init and
``param_counts``, so a config built here compares equal field by field
with the reference's.  Note ``TrainConfig.grad_compression_block`` (64)
differs from ``dist.compression.DEFAULT_BLOCK`` (256): the coded step
always passes the block from the config.
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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters + HGC wiring."""

    optimizer: str = "adamw"  # sgd | momentum | adamw | adafactor
    lr: float = 3e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    microbatch: int = 0  # 0 ⇒ no accumulation; else per-step microbatch
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    # HGC (aggregation scheme at the data-parallel layer)
    scheme: str = "uncoded"  # any of core.schemes.SCHEME_NAMES
    s_e: int = 1
    s_w: int = 1
    K: int = 0  # 0 ⇒ auto (compatible_K)
    # fault tolerance
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    # distributed perf knobs (see EXPERIMENTS.md §Perf)
    remat_policy: str = "layer"  # layer | none | dots
    # aggregation execution mode (launch.train --dist):
    #   off        — single-host reference loop, λ rides the batch weights
    #   coded      — shard_map two-stage coded psum on a (pod, data[, model]) mesh
    #   coded_int8 — same, with the int8 + error-feedback cross-pod hop
    #   coded_q    — same, codec chosen by grad_compression (int8|int4|fp8)
    dist_mode: str = "off"
    # edge→master hop codec: none | int8 | int4 (packed nibbles) | fp8
    # (e4m3); all three share the EF-residual contract, so checkpoints
    # restore across codecs (dist/compression.py)
    grad_compression: str = "none"
    grad_compression_block: int = 64  # quantization block on that hop
    fsdp: bool = True  # shard params over the data axis as well
    # sequence parallelism (Megatron SP) inside the dist-TP shard_map:
    # row-parallel out-projections reduce-scatter over seq, the
    # norm/residual work between the TP collective pairs runs on the
    # local 1/tp seq block, column-parallel in-projections re-gather.
    # Config-level default; the train CLI's --seq-shard/--no-seq-shard
    # flag (CodedSession ``seq_shard=``) overrides it.  Needs tp > 1
    # and seq_len % tp == 0 (sharding.validate_seq_shard).
    seq_shard_activations: bool = False
    # pipeline parallelism over the leading "stage" mesh axis: the
    # stacked layer groups shard stage-wise (each stage owns a
    # contiguous block of n_groups // pp_stages groups) and the dist
    # train step runs a microbatched pipeline schedule with ppermute
    # activation handoffs.  Needs n_groups % pp_stages == 0
    # (sharding.validate_pp).  1 ⇒ off (no "stage" mesh axis at all).
    pp_stages: int = 1
    # pipeline microbatch COUNT per step (distinct from ``microbatch``,
    # the accumulation SIZE of the single-host path): the per-group
    # coded batch splits into this many microbatches flowing through
    # the stage pipeline.  0 ⇒ pp_stages (minimum that fills the
    # pipeline); must divide the per-group batch rows.
    microbatches: int = 0
