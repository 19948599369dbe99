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
    return_lse: bool = False,
):
    """Causal/windowed/softcapped GQA self-attention over ``arange``
    positions — ``models.attention.attention`` with its dense/chunked
    size dispatch, i.e. what the reference's prefill computes.  With
    ``return_lse`` also each row's log-sum-exp (B, S, H) float32 of its
    scaled, softcapped and masked scores (mask value −1e30)."""
    q_pos = torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    out = attn_lib.attention(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, softcap=softcap)
    if not return_lse:
        return out
    B, S, H, Dh = q.shape
    Kv = k.shape[2]
    qf = q.to(torch.float32).reshape(B, S, Kv, H // Kv, Dh)
    s = torch.einsum("bskgd,btkd->bskgt", qf * attn_lib._scale(Dh),
                     k.to(torch.float32))
    s = attn_lib._softcap(s, softcap)
    ok = attn_lib._allowed(q_pos, k_pos, causal, window)  # (S, T)
    s = torch.where(ok[None, :, None, None], s, attn_lib.NEG_INF)
    return out, torch.logsumexp(s, dim=-1).reshape(B, S, H)


# ----------------------------------------------------------------------
# coded combine: out (R, F) = C (R, K) @ G (K, F), dequantized
# ----------------------------------------------------------------------
def coded_combine_ref(coeff: torch.Tensor, grads: torch.Tensor
                      ) -> torch.Tensor:
    """out[r, f] = Σ_k coeff[r, k] · grads[k, f], float32: the encode
    (eq. 22) and decode (eqs. 25/27) of the paper."""
    return torch.einsum("rk,kf->rf", coeff.to(torch.float32),
                        grads.to(torch.float32))


def _dequant_combine(coeff, g, scales, block):
    K, F = g.shape
    g = g.reshape(K, F // block, block) * scales[:, :, None]
    out = torch.einsum("rk,knb->rnb", coeff.to(torch.float32), g)
    return out.reshape(coeff.shape[0], F)


def coded_combine_q_ref(coeff, grads_q, scales, block: int):
    """int8 payload (K, F) × one f32 scale per block, then ``C @ ·``."""
    return _dequant_combine(coeff, grads_q.to(torch.float32), scales, block)


def coded_combine_q4_ref(coeff, grads_q, scales, block: int):
    """Packed int4 (K, F/2): value 2i in the low nibble of byte i,
    sign-extended ``((p & 0xF) ^ 8) - 8``; then the q combine."""
    K, F2 = grads_q.shape
    p = grads_q.to(torch.int32) & 0xFF
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    g = torch.stack([lo, hi], dim=-1).reshape(K, 2 * F2)
    return _dequant_combine(coeff, g.to(torch.float32), scales, block)


def coded_combine_f8_ref(coeff, grads_q, scales, block: int):
    """fp8-e4m3 payload (K, F), upcast exactly, × scale, then ``C @ ·``."""
    return _dequant_combine(coeff, grads_q.to(torch.float32), scales, block)


# ----------------------------------------------------------------------
# MoE shuffle: the sorted (token, choice) stream into the experts' slots
# and back (``models.moe.dispatch_slots``'s plan), with autograd
# ----------------------------------------------------------------------
def moe_dispatch_ref(x: torch.Tensor, order: torch.Tensor,
                     slot: torch.Tensor, n_slots: int,
                     top_k: int) -> torch.Tensor:
    """The tokens ``x`` (N, d) → the slots (n_slots, d): each token's
    ``top_k`` copies sorted by ``order`` and put at ``slot`` (the
    sentinel ``n_slots`` takes the dropped ones and is discarded); zeros
    in the empty slots."""
    N, d = x.shape
    x_sorted = x[:, None, :].expand(N, top_k, d).reshape(N * top_k, d)
    x_sorted = x_sorted.index_select(0, order)
    buf = x.new_zeros((n_slots + 1, d)).index_put((slot,), x_sorted)
    return buf[:n_slots]


def moe_combine_ref(out: torch.Tensor, w: torch.Tensor, order: torch.Tensor,
                    slot: torch.Tensor) -> torch.Tensor:
    """The slots' rows ``out`` (n_slots, d) → y (N, d): gathered back by
    ``slot`` (the sentinel row zero), weighted by ``w`` (N, k) in the
    rows' dtype, unsorted and summed over the k copies in order."""
    d = out.shape[-1]
    N, k = w.shape
    out = torch.cat([out, out.new_zeros((1, d))])
    w_sorted = w.reshape(-1).index_select(0, order)
    contrib = out.index_select(0, slot) * w_sorted[:, None].to(out.dtype)
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(order.numel(), device=order.device)
    return contrib.index_select(0, unsort).reshape(N, k, d).sum(dim=1)
