"""Plain PyTorch versions of the hand-written kernels.

Each function here computes what its kernel computes, on any device, in
plain tensor code.  ``kernels.ops`` runs them for tensors that lie on
the CPU; ``chip_smoke.py`` and the CUDA tests hold the kernels against
them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib


def decode_attention_ref(
    q: torch.Tensor,        # (B, 1, H, Dh) — one new token per sequence
    k_cache: torch.Tensor,  # (B, C, Kv, Dh) ring-buffer keys
    v_cache: torch.Tensor,  # (B, C, Kv, Dh) ring-buffer values
    q_pos,                  # int or 0-dim int tensor: position of the token
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """GQA decode attention over a ring-buffer cache.

    The slot positions come from ``q_pos`` by the ring formula the
    kernel evaluates per slot, ``k_pos = s + W·⌊(q_pos − s)/W⌋`` with
    ``W = window or C`` (as ``repro.kernels.ops.decode_attention`` does
    for its oracle); a slot is attendable iff it holds a real position
    ≤ q_pos inside the window.
    """
    C = k_cache.shape[1]
    weff = window if window > 0 else C
    if not isinstance(q_pos, torch.Tensor):
        q_pos = torch.tensor(q_pos, dtype=torch.int32, device=q.device)
    k_pos = attn_lib.ring_slot_positions(C, q_pos + 1, weff)
    return attn_lib.decode_attention(q, k_cache, v_cache, q_pos, k_pos,
                                     window=window, softcap=softcap)


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, T, Kv, Dh)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Causal/windowed/softcapped GQA self-attention over ``arange``
    positions — ``models.attention.attention`` with its dense/chunked
    size dispatch, i.e. what the reference's prefill computes."""
    q_pos = torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    return attn_lib.attention(q, k, v, q_pos, k_pos, causal=causal,
                              window=window, softcap=softcap)
