"""The benchmark's yardstick arithmetic: the card's peaks, each kernel's
work as its roofline counts it, and a step's model FLOPs.

The kernel work functions are frozen copies of the ones the port's
on-card smoke script used when this benchmark was defined; the program
may change its own copies, and these stay as they are.  A kernel's
bound counts each input byte read once and each output byte written
once, and its operations at the dtype's peak.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

#: NVIDIA H100 SXM data sheet, dense rates: HBM bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(least milliseconds the card could take, what bounds it)."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def flash_work(batch, S, T, H, KV, DH, pairs, elem=2, with_lse=False):
    """(bytes, operations) of one flash call: q, k, v read once and the
    output (and the log-sum-exp) written once, 4 · Dh operations a head
    for each attended (query, key) pair."""
    nbytes = (2 * batch * S * H * DH + 2 * batch * T * KV * DH) * elem \
        + (batch * S * H * 4 if with_lse else 0)
    return nbytes, 4 * batch * H * DH * pairs


def decode_work(B, H, KV, DH, n_valid, elem=2):
    """(bytes, operations) of one decode call: the ``n_valid`` attended
    slots of K and V read once, q read, the output written, ``q_pos``."""
    nbytes = (2 * B * n_valid * KV * DH + 2 * B * H * DH) * elem + 4
    return nbytes, 4 * B * H * n_valid * DH


def combine_work(R, K, F, payload_bytes, n_scales=0):
    """(bytes, operations) of one combine: the (K, F) payload, the (R, K)
    coefficients and the scales read once, the (R, F) f32 output written
    once; 2 · R · K · F operations, and K · F to dequantize."""
    nbytes = payload_bytes + R * K * 4 + R * F * 4 + n_scales * 4
    return nbytes, 2 * R * K * F + (K * F if n_scales else 0)


def causal_pairs(S: int) -> int:
    """(query, key) pairs with key ≤ query over ``S`` positions."""
    return S * (S + 1) // 2


def matmul_params(m: Dict) -> int:
    """Parameters one token multiplies through in one forward, the head
    included and the embedding lookup not: attention's projections, the
    dense MLP or the router plus ``top_k`` experts, in every layer."""
    d, H, Kv, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = d * H * Dh + 2 * d * Kv * Dh + H * Dh * d
    if m.get("n_experts", 0):
        ffn = m["top_k"] * 3 * d * m["d_ff"] + d * m["n_experts"]
    else:
        ffn = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + ffn) + d * m["vocab"]


def attention_flops(m: Dict, pairs: int) -> int:
    """Forward attention FLOPs of one row over ``pairs`` attended
    (query, key) pairs in every layer: 4 · Dh a head a pair."""
    return m["n_layers"] * 4 * m["n_heads"] * m["head_dim"] * pairs


def train_step_flops(m: Dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step over ``rows`` rows of ``seq``
    tokens: forward and backward (3 × the forward), no recompute."""
    fwd = 2 * matmul_params(m) * rows * seq \
        + rows * attention_flops(m, causal_pairs(seq))
    return 3.0 * fwd


def prefill_flops(m: Dict, batch: int, prompt: int) -> float:
    """Forward FLOPs of a bulk prefill that unembeds only the last
    position of each row."""
    d, V = m["d_model"], m["vocab"]
    body = 2 * (matmul_params(m) - d * V) * batch * prompt
    return body + batch * attention_flops(m, causal_pairs(prompt)) \
        + 2 * d * V * batch


def decode_flops(m: Dict, batch: int, positions: Iterable[int]) -> float:
    """Forward FLOPs of decode steps whose new tokens sit at
    ``positions`` (each attends to position + 1 cached slots)."""
    total = 0.0
    for q_pos in positions:
        total += 2 * matmul_params(m) * batch \
            + batch * attention_flops(m, q_pos + 1)
    return total
