"""Public entry points over the port's kernels, dispatched by device.

A CUDA tensor launches the hand-written Hopper kernel, or the call
raises; a CPU tensor runs the kernel's plain version
(``kernels.ref``).  There is no fallback from one to the other.

A ``meta`` tensor (the dry run, ``launch.op_analysis``) computes
nothing: the wrapper returns an empty ``meta`` output of the kernel's
shape and dtype and adds the kernel's own work to :data:`META_WORK` —
its operations and bytes as ``chip_smoke.py``'s bound counts them (each
input byte read once, each output written once) and, apart, the S×T
score elements that the attention kernels keep on chip and the plain
version would write to memory.  The launch counters do not move.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import _tree, obs
from repro_torch.kernels import moe_shuffle, ref
from repro_torch.kernels.coded_combine import (
    coded_combine,
    coded_combine_f8,
    coded_combine_q,
    coded_combine_q4,
)
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd

PyTree = Any

#: every kernel wrapper of the port, by kernel name
KERNELS = {
    "decode_attention": decode_attention_fwd,
    "flash_attention": flash_attention_fwd,
    "coded_combine": coded_combine,
    "coded_combine_q": coded_combine_q,
    "coded_combine_q4": coded_combine_q4,
    "coded_combine_f8": coded_combine_f8,
    "moe_dispatch": moe_shuffle.moe_dispatch,
    "moe_combine": moe_shuffle.moe_combine,
    "moe_dispatch_bwd": moe_shuffle.moe_dispatch_bwd,
    "moe_combine_bwd": moe_shuffle.moe_combine_bwd,
}


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel route for device {t.device}")
    return t.device.type


#: the kernels' work on the ``meta`` device since :func:`reset_meta_work`,
#: by kernel name: ``calls``, ``flops``, ``bytes`` (the kernel's own) and
#: ``scores`` (the S×T elements the plain version would materialize)
META_WORK: Dict[str, Dict[str, float]] = {}


def reset_meta_work() -> None:
    META_WORK.clear()


def _meta_work(name: str, flops: float, nbytes: float,
               scores: float = 0.0) -> None:
    w = META_WORK.setdefault(name, dict(calls=0, flops=0.0, bytes=0.0,
                                        scores=0.0))
    w["calls"] += 1
    w["flops"] += float(flops)
    w["bytes"] += float(nbytes)
    w["scores"] += float(scores)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attended_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the flash kernel attends: positions
    ``0..S-1`` × ``0..T-1`` under the causal and window masks
    (``models.attention._allowed``)."""
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(S,
                                                                   np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def valid_slots(C: int, q_pos, window: int) -> int:
    """The cache slots the decode kernel reads: those of a ``C``-slot
    ring (``window`` 0: the whole cache) holding a position within the
    window up to ``q_pos``; a tensor ``q_pos`` (on the ``meta`` device:
    no value) counts a full cache, ``q_pos = C − 1``."""
    if isinstance(q_pos, torch.Tensor):
        q_pos = C - 1
    w = window or C
    s = np.arange(C, dtype=np.int64)
    k_pos = s + w * np.floor_divide(q_pos - s, w)  # length q_pos + 1
    ok = (k_pos >= 0) & (k_pos <= q_pos)
    if window > 0:
        ok &= q_pos - k_pos < window
    return int(ok.sum())


def decode_attention(q, k_cache, v_cache, q_pos, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Ring-buffer GQA decode attention; out (B, 1, H, Dh).

    ``q_pos`` is the new token's position: an int, or an int32 tensor
    on ``q``'s device (the decode cache's ``length``), which the kernel
    reads on the device.
    """
    route = _route(q)
    if route == "cuda":
        return decode_attention_fwd(q, k_cache, v_cache, q_pos,
                                    window=window, softcap=softcap)
    if route == "meta":
        B, _, H, Dh = q.shape
        Kv = k_cache.shape[2]
        n = valid_slots(k_cache.shape[1], q_pos, window)
        _meta_work("decode_attention", 4 * B * H * n * Dh,
                   2 * B * n * Kv * Dh * k_cache.element_size()
                   + 2 * _nbytes(q) + 4, scores=B * H * n)
        return torch.empty_like(q)
    return ref.decode_attention_ref(q, k_cache, v_cache, q_pos,
                                    window=window, softcap=softcap)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, return_lse: bool = False):
    """Self-attention over positions ``0..S-1`` × ``0..T-1``; out
    (B, S, H, Dh) [, each row's log-sum-exp (B, S, H) float32]."""
    route = _route(q)
    if route == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=return_lse)
    if route == "meta":
        B, S, H, Dh = q.shape
        T = k.shape[1]
        out = torch.empty_like(q)
        _meta_work("flash_attention",
                   4 * B * H * Dh * attended_pairs(S, T, causal, window),
                   2 * _nbytes(q) + 2 * _nbytes(k)
                   + (B * S * H * 4 if return_lse else 0),
                   scores=B * H * S * T)
        if return_lse:
            return out, q.new_empty((B, S, H), dtype=torch.float32)
        return out
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=return_lse)


# ----------------------------------------------------------------------
# coded combine (eqs. 22/25/27) and the compressed hop's fused dequant
# ----------------------------------------------------------------------
def _combine_meta(name: str, coeff, grads, scales, F: int) -> torch.Tensor:
    """The combine's empty ``meta`` output (R, F) float32 and its work."""
    R, K = coeff.shape
    out = grads.new_empty((R, F), dtype=torch.float32)
    extra = 0 if scales is None else K * F
    _meta_work(name, 2 * R * K * F + extra, _nbytes(grads, coeff, out)
               + (0 if scales is None else _nbytes(scales)))
    return out


def combine(coeff, grads) -> torch.Tensor:
    """out (R, F) = coeff (R, K) @ grads (K, F), float32."""
    route = _route(grads)
    if route == "cuda":
        return coded_combine(coeff, grads)
    if route == "meta":
        return _combine_meta("coded_combine", coeff, grads, None,
                             grads.shape[-1])
    return ref.coded_combine_ref(coeff, grads)


def combine_q(coeff, grads_q, scales, block: int = 128) -> torch.Tensor:
    """int8 payload (K, F) dequantized by block, then ``coeff @ ·``."""
    route = _route(grads_q)
    if route == "cuda":
        return coded_combine_q(coeff, grads_q, scales, block=block)
    if route == "meta":
        return _combine_meta("coded_combine_q", coeff, grads_q, scales,
                             grads_q.shape[-1])
    return ref.coded_combine_q_ref(coeff, grads_q, scales, block)


def combine_q4(coeff, grads_q, scales, block: int = 128) -> torch.Tensor:
    """Packed int4 payload (K, F // 2) dequantized by block, then ``coeff @ ·``."""
    route = _route(grads_q)
    if route == "cuda":
        return coded_combine_q4(coeff, grads_q, scales, block=block)
    if route == "meta":
        return _combine_meta("coded_combine_q4", coeff, grads_q, scales,
                             2 * grads_q.shape[-1])
    return ref.coded_combine_q4_ref(coeff, grads_q, scales, block)


def combine_f8(coeff, grads_q, scales, block: int = 128) -> torch.Tensor:
    """fp8-e4m3 payload (K, F) dequantized by block, then ``coeff @ ·``."""
    route = _route(grads_q)
    if route == "cuda":
        return coded_combine_f8(coeff, grads_q, scales, block=block)
    if route == "meta":
        return _combine_meta("coded_combine_f8", coeff, grads_q, scales,
                             grads_q.shape[-1])
    return ref.coded_combine_f8_ref(coeff, grads_q, scales, block)


#: compression mode → fused dequant-combine wrapper
COMBINE_BY_MODE = {"int8": combine_q, "int4": combine_q4, "fp8": combine_f8}


def combine_compressed(mode: str, coeff, grads_q, scales,
                       block: int = 128) -> torch.Tensor:
    """The fused combine matching a compression codec."""
    try:
        fn = COMBINE_BY_MODE[mode]
    except KeyError:
        raise ValueError(
            f"no fused combine for compression mode {mode!r}") from None
    return fn(coeff, grads_q, scales, block=block)


# ----------------------------------------------------------------------
# the MoE layer's token permutation into and out of the experts' slots
# ----------------------------------------------------------------------
def shuffle_work(name: str, N: int, k: int, n_slots: int, d: int,
                 elem: int, filled: int):
    """(bytes, operations) of one MoE shuffle pass, as ``chip_smoke.py``'s
    bound counts them: each input byte read once (of the slots' rows,
    only the ``filled`` ones the plan names), each output written once.
    ``N`` tokens of ``k`` entries, ``n_slots`` rows of ``d`` values of
    ``elem`` bytes; the plan's ``src`` (n_slots) and ``slot_tk`` (N·k)
    int32, the weights float32."""
    rows, toks, filled_rows = n_slots * d * elem, N * d * elem, \
        filled * d * elem
    return {
        "moe_dispatch": (toks + 4 * N * k + 4 * n_slots + rows, 0),
        "moe_combine": (filled_rows + 8 * N * k + toks, 2 * filled * d),
        "moe_dispatch_bwd": (filled_rows + 4 * N * k + toks, filled * d),
        "moe_combine_bwd": (toks + filled_rows + 4 * n_slots + 8 * N * k
                            + rows + 4 * N * k, 3 * filled * d),
    }[name]


def _shuffle_meta(name: str, N: int, k: int, n_slots: int,
                  rows: torch.Tensor) -> None:
    """A shuffle pass's work on ``meta``, where no routing is known:
    every slot the entries could fill, ``min(n_slots, N·k)``."""
    nbytes, flops = shuffle_work(name, N, k, n_slots, rows.shape[-1],
                                 rows.element_size(), min(n_slots, N * k))
    _meta_work(name, flops, nbytes)


def _dispatch_fwd(x, slot_tk, src):
    if _route(x) == "meta":
        _shuffle_meta("moe_dispatch", *slot_tk.shape, src.numel(), x)
        return x.new_empty((src.numel(), x.shape[-1]))
    return moe_shuffle.moe_dispatch(x, slot_tk, src)


def _dispatch_bwd(dbuf, slot_tk):
    N, k = slot_tk.shape
    if _route(dbuf) == "meta":
        _shuffle_meta("moe_dispatch_bwd", N, k, dbuf.shape[0], dbuf)
        return dbuf.new_empty((N, dbuf.shape[-1]))
    return moe_shuffle.moe_dispatch_bwd(dbuf, slot_tk)


def _combine_fwd(out, w, slot_tk):
    N, k = slot_tk.shape
    if _route(out) == "meta":
        _shuffle_meta("moe_combine", N, k, out.shape[0], out)
        return out.new_empty((N, out.shape[-1]))
    return moe_shuffle.moe_combine(out, w, slot_tk)


def _combine_bwd(dy, out, w, slot_tk, src):
    N, k = slot_tk.shape
    if _route(out) == "meta":
        _shuffle_meta("moe_combine_bwd", N, k, out.shape[0], out)
        return (out.new_empty(out.shape),
                out.new_empty((N, k), dtype=torch.float32))
    return moe_shuffle.moe_combine_bwd(dy, out, w, slot_tk, src)


class _Dispatch(torch.autograd.Function):
    """x (N, d) → the slots (n_slots, d); backward: the unweighted
    gather-sum of the slots' gradient back to each token."""

    @staticmethod
    def forward(ctx, x, slot_tk, src):
        ctx.save_for_backward(slot_tk)
        return _dispatch_fwd(x, slot_tk, src)

    @staticmethod
    def backward(ctx, dbuf):
        (slot_tk,) = ctx.saved_tensors
        return _dispatch_bwd(dbuf.contiguous(), slot_tk), None, None


class _Combine(torch.autograd.Function):
    """The experts' rows (n_slots, d) and the weights (N, k) → y (N, d);
    backward: one pass for both gradients."""

    @staticmethod
    def forward(ctx, out, w, slot_tk, src):
        w = w.contiguous()
        ctx.save_for_backward(out, w, slot_tk, src)
        return _combine_fwd(out, w, slot_tk)

    @staticmethod
    def backward(ctx, dy):
        out, w, slot_tk, src = ctx.saved_tensors
        dout, dw = _combine_bwd(dy.contiguous().to(out.dtype), out, w,
                                slot_tk, src)
        return dout, dw, None, None


def moe_dispatch(x: torch.Tensor, plan) -> torch.Tensor:
    """The tokens ``x`` (N, d) into the experts' slots (n_slots, d) by
    ``plan`` (``models.moe.shuffle_plan``); zeros in the empty slots."""
    if _route(x) == "cpu":
        return ref.moe_dispatch_ref(x, plan.order, plan.slot,
                                    plan.src.numel(), plan.top_k)
    return _Dispatch.apply(x, plan.slot_tk, plan.src)


def moe_combine(out: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
    """The experts' rows ``out`` (n_slots, d) back to the tokens: y (N, d)
    ``= Σ_j w[t, j] · out[slot of (t, j)]`` over the kept entries, with
    ``w`` (N, k) float32."""
    if _route(out) == "cpu":
        return ref.moe_combine_ref(out, w, plan.order, plan.slot)
    return _Combine.apply(out, w, plan.slot_tk, plan.src)


def flatten_tree(tree: PyTree) -> torch.Tensor:
    """Every leaf raveled and concatenated, in the reference's leaf order."""
    return torch.cat([x.reshape(-1) for x in _tree.leaves(tree)])


def unflatten_like(vec: torch.Tensor, tree: PyTree) -> PyTree:
    """Inverse of :func:`flatten_tree` onto ``tree``'s shapes and dtypes."""
    out, off = [], 0
    for leaf in _tree.leaves(tree):
        n = leaf.numel()
        out.append(vec[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return _tree.unflatten_like(tree, out)


def encode_messages(code, g_parts: torch.Tensor) -> torch.Tensor:
    """All workers' messages G_ij at once: (Σm_i, F) = E @ g_parts, with
    ``E`` the collapsed encoding matrix — one kernel launch (eq. 22)."""
    E = torch.as_tensor(np.asarray(code.encoding_matrix_flat(), np.float32),
                        device=g_parts.device)
    return combine(E, g_parts)


def decode_gradient(code, messages: torch.Tensor, fast_edges,
                    fast_workers) -> torch.Tensor:
    """The decoded full gradient from worker messages via the λ weights
    (eqs. 25/27 collapsed into one row)."""
    lam = np.asarray(code.collapsed_weights(fast_edges, fast_workers),
                     np.float32)
    lam = torch.as_tensor(lam, device=messages.device)
    return combine(lam[None, :], messages)[0]


def launch_counts() -> Dict[str, float]:
    """``obs.snapshot()``: every kernel of :data:`KERNELS` by name, its
    launches since the last :func:`reset_launch_counts`; while a profiler
    recorded, also the spans' ``span.<name>.n``, ``.host_ms`` and
    ``.device_ms`` and the counters' ``count.<name>``
    (:mod:`repro_torch.obs`).  With no profiler recording since the
    reset, the kernel names alone."""
    return obs.snapshot()


def reset_launch_counts() -> None:
    """``obs.reset()``: the launch counts, spans and counters cleared."""
    obs.reset()
