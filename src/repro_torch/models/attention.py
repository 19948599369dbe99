"""Attention machinery of the port: GQA, RoPE and M-RoPE, dense &
chunked (online-softmax) variants, sliding windows, ring-buffer decode
caches.

PyTorch counterpart of ``repro.models.attention`` with the same layout
conventions and the same function names:

  q:      (B, S, H,  Dh)
  k, v:   (B, T, Kv, Dh)      H = G · Kv (grouped-query attention)

All softmax math runs in float32 regardless of input dtype.  These are
the plain versions: the serving path reaches the hand-written kernels
through ``repro_torch.kernels.ops``, which falls to these functions only
for tensors that lie on the CPU.  Training attends through
:class:`FlashAttention`, whose forward is the flash kernel and whose
backward is the reference's recompute backward in PyTorch ops.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def local_head_counts(p, head_dim: int) -> Tuple[int, int]:
    """(H, Kv) as seen by THIS rank's projection weights.

    Under tensor parallelism the attention weights are per-rank
    column/row blocks, so the head counts come from the local shapes,
    not the config: Q heads shard over the "model" axis while K/V heads
    replicate whenever ``n_kv_heads`` does not divide the degree
    (Megatron's GQA fallback).  Everything downstream (RoPE, GQA
    grouping, the attention kernels) keys off these shapes.
    """
    return p["wq"].shape[-1] // head_dim, p["wk"].shape[-1] // head_dim


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                sections: Tuple[int, ...] = ()
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles, each (B, S, 1, Dh/2) float32.

    ``positions`` is (B, S), or (3, B, S) for M-RoPE (qwen2-vl): the
    Dh/2 frequency slots are split into ``sections`` (e.g. (16, 24, 24)
    for Dh 128), slot ``i`` driven by the temporal, height or width
    stream ``repeat(arange(3), sections)[i]``.  The transformer computes
    the tables once per forward or decode step and rotates every layer's
    q and k with :func:`rotate` — the same values :func:`apply_rope`
    computes per call.
    """
    inv = rope_freqs(head_dim, theta, positions.device)  # (Dh/2,)
    if positions.ndim == 3:  # M-RoPE
        if not sections:
            raise ValueError("M-RoPE positions need mrope sections")
        assert sum(sections) == head_dim // 2, (sections, head_dim)
        pos = positions.to(torch.float32)
        ends = [sum(sections[:j + 1]) for j in range(len(sections))]
        ang = torch.cat([pos[j][..., None] * inv[end - n:end]
                         for j, (n, end) in enumerate(zip(sections, ends))],
                        -1)  # (B, S, Dh/2)
    else:
        ang = positions.to(torch.float32)[..., None] * inv  # (B, S, Dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Apply precomputed rotary tables to ``x`` (B, S, H, Dh)."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10_000.0,
    sections: Tuple[int, ...] = (),
) -> torch.Tensor:
    """Rotary embedding.  ``positions``: (B, S), or (3, B, S) with
    ``sections`` for M-RoPE (:func:`rope_tables`)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, sections))


# ----------------------------------------------------------------------
# masks
# ----------------------------------------------------------------------
def _allowed(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
             window: int) -> torch.Tensor:
    """(..., S, T) boolean mask of allowed attention edges."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = k >= 0
    if causal:
        ok = ok & (k <= q)
    if window > 0:
        ok = ok & (q - k < window)
    return ok


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


def _scale(Dh: int) -> float:
    return 1.0 / float(Dh) ** 0.5


# ----------------------------------------------------------------------
# dense attention
# ----------------------------------------------------------------------
def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Reference/materializing attention; fine for short sequences."""
    B, S, H, Dh = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qf = q.to(torch.float32).reshape(B, S, Kv, G, Dh)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qf * _scale(Dh), kf)
    scores = _softcap(scores, softcap)
    mask = _allowed(q_pos, k_pos, causal, window)  # (B?, S, T)
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vf)
    return out.reshape(B, S, H, Dh).to(q.dtype)


# ----------------------------------------------------------------------
# chunked (online softmax) attention
# ----------------------------------------------------------------------
def _kv_chunk_scan(
    q: torch.Tensor,  # (B, S, Kv, G, Dh) f32, pre-scaled
    k: torch.Tensor,  # (B, T, Kv, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (S,)
    k_pos: torch.Tensor,  # (T,)
    chunk: int,
    causal: bool,
    window: int,
    softcap: float,
) -> torch.Tensor:
    B, S, Kv, G, Dh = q.shape
    T = k.shape[1]
    m = torch.full((B, Kv, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Kv, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kv, G, S, Dh), dtype=torch.float32,
                      device=q.device)
    for start in range(0, T, chunk):
        kc = k[:, start:start + chunk].to(torch.float32)
        vc = v[:, start:start + chunk].to(torch.float32)
        kp = k_pos[start:start + chunk]
        s = torch.einsum("bskgd,btkd->bkgst", q, kc)
        s = _softcap(s, softcap)
        mask = _allowed(q_pos, kp, causal, window)  # (S, chunk)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.movedim(3, 1)  # (B, S, Kv, G, Dh)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (S,) shared positions (no batch offsets)
    k_pos: torch.Tensor,  # (T,)
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    kv_chunk: int = 1024,
    q_chunk: int = 0,
) -> torch.Tensor:
    """Memory-bounded attention: loop over KV chunks, optional q-chunking."""
    B, S, H, Dh = q.shape
    Kv = k.shape[2]
    G = H // Kv
    T = k.shape[1]
    kv_chunk = min(kv_chunk, T)
    if T % kv_chunk:
        raise ValueError(f"T={T} not divisible by kv_chunk={kv_chunk}")
    qf = (q.to(torch.float32) * _scale(Dh)).reshape(B, S, Kv, G, Dh)
    if q_chunk and S > q_chunk:
        if S % q_chunk:
            raise ValueError(f"S={S} not divisible by q_chunk={q_chunk}")
        out = torch.cat([
            _kv_chunk_scan(qf[:, i:i + q_chunk], k, v,
                           q_pos[i:i + q_chunk], k_pos, kv_chunk, causal,
                           window, softcap)
            for i in range(0, S, q_chunk)
        ], dim=1)
    else:
        out = _kv_chunk_scan(qf, k, v, q_pos, k_pos, kv_chunk, causal,
                             window, softcap)
    return out.reshape(B, S, H, Dh).to(q.dtype)


def attention(
    q, k, v, q_pos, k_pos, *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    kv_chunk: int = 1024,
    q_chunk_threshold: int = 8192,
    q_chunk: int = 2048,
):
    """Size-dispatching attention used by the transformer blocks."""
    S, T = q.shape[1], k.shape[1]
    if T <= kv_chunk * 2:
        qp = q_pos if q_pos.ndim > 1 else q_pos[None]
        kp = k_pos if k_pos.ndim > 1 else k_pos[None]
        return dense_attention(q, k, v, qp, kp, causal=causal,
                               window=window, softcap=softcap)
    return chunked_attention(
        q, k, v, q_pos, k_pos,
        causal=causal, window=window, softcap=softcap, kv_chunk=kv_chunk,
        q_chunk=q_chunk if S >= q_chunk_threshold else 0,
    )


# ----------------------------------------------------------------------
# flash attention with the reference's recompute backward (training)
# ----------------------------------------------------------------------
def _flash_bwd(q, k, v, out, lse, do, causal: bool, window: int,
               softcap: float, kv_chunk: int):
    """Recompute backward of ``repro.models.attention._flash_vjp_bwd``
    (``_flash_bwd_scan``): per kv chunk, p = exp(s − lse) from the saved
    log-sum-exp; dK/dV summed over each GQA group, softcap's
    ``1 − tanh²`` factor, masked entries (−1e30) contributing nothing."""
    B, S, H, Dh = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    chunk = min(kv_chunk, T)
    scale = _scale(Dh)
    qf = (q.to(torch.float32) * scale).reshape(B, S, Kv, G, Dh)
    dof = do.to(torch.float32).reshape(B, S, Kv, G, Dh)
    delta = (dof * out.to(torch.float32).reshape(B, S, Kv, G, Dh)).sum(-1)
    lse_t = lse.reshape(B, S, Kv, G).permute(0, 2, 3, 1)[..., None]
    do_t = dof.permute(0, 2, 3, 1, 4)  # (B, Kv, G, S, Dh)
    delta_t = delta.permute(0, 2, 3, 1)[..., None]  # (B, Kv, G, S, 1)
    q_pos = torch.arange(S, device=q.device)
    dq = torch.zeros((B, S, Kv, G, Dh), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, T, Kv, Dh), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for start in range(0, T, chunk):
        kc = k[:, start:start + chunk].to(torch.float32)
        vc = v[:, start:start + chunk].to(torch.float32)
        kp = torch.arange(start, start + kc.shape[1], device=q.device)
        s_raw = torch.einsum("bskgd,btkd->bkgst", qf, kc)
        mask = _allowed(q_pos, kp, causal, window)[None, None, None]
        s = torch.where(mask, _softcap(s_raw, softcap), NEG_INF)
        p = torch.exp(s - lse_t)  # (B, Kv, G, S, t)
        dv[:, start:start + chunk] = torch.einsum("bkgst,bkgsd->btkd", p,
                                                  do_t)
        dp = torch.einsum("bkgsd,btkd->bkgst", do_t, vc)
        ds = p * (dp - delta_t)
        if softcap and softcap > 0:
            th = torch.tanh(s_raw / softcap)
            ds = ds * (1.0 - th * th)
        ds = torch.where(mask, ds, 0.0)
        dq += torch.einsum("bkgst,btkd->bskgd", ds, kc)
        dk[:, start:start + chunk] = torch.einsum("bkgst,bskgd->btkd", ds,
                                                  qf)
    dq = (dq * scale).reshape(B, S, H, Dh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Self-attention over positions ``0..S-1`` × ``0..T-1`` that saves
    only (out, log-sum-exp) for its backward, as the reference's flash
    custom VJP does.  Forward: ``kernels.ops.flash_attention`` (the CUDA
    kernel on the card, its plain version on the CPU); backward:
    :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, kv_chunk):
        from repro_torch.kernels import ops  # ops' plain versions import this module

        out, lse = ops.flash_attention(q.detach(), k.detach(), v.detach(),
                                       causal=causal, window=window,
                                       softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kv_chunk: int = 1024):
    """Memory-O(S) attention with the recompute backward (GQA-aware)."""
    return FlashAttention.apply(q, k, v, causal, window, softcap, kv_chunk)


# ----------------------------------------------------------------------
# decode (single new token against a cache)
# ----------------------------------------------------------------------
def ring_slot_positions(cache_size: int, length, window: int,
                        device=None) -> torch.Tensor:
    """Absolute position held in each ring-buffer slot.

    Slot s holds position p = s + w·⌊(L−1−s)/w⌋ (negative ⇒ empty).
    For full (non-ring) caches pass window = cache_size.
    """
    if isinstance(length, torch.Tensor):
        device = length.device
    s = torch.arange(cache_size, device=device)
    return s + window * torch.div(length - 1 - s, window,
                                  rounding_mode="floor")


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, Dh) — rope already applied
    k_cache: torch.Tensor,  # (B, C, Kv, Dh)
    v_cache: torch.Tensor,
    q_pos,  # scalar current position (= length − 1)
    k_pos: torch.Tensor,  # (C,) absolute positions per slot
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, Dh = q.shape
    Kv = k_cache.shape[2]
    G = H // Kv
    qf = q.to(torch.float32).reshape(B, Kv, G, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf * _scale(Dh),
                     k_cache.to(torch.float32))
    s = _softcap(s, softcap)
    ok = (k_pos >= 0) & (k_pos <= q_pos)
    if window > 0:
        ok = ok & (q_pos - k_pos < window)
    s = torch.where(ok[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, Dh).to(q.dtype)
