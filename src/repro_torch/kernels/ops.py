"""Public entry points over the port's kernels, dispatched by device.

A CUDA tensor launches the hand-written Hopper kernel, or the call
raises; a CPU tensor runs the kernel's plain version
(``kernels.ref``).  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.kernels import ref
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
}


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel route for device {t.device}")
    return t.device.type


def decode_attention(q, k_cache, v_cache, q_pos, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Ring-buffer GQA decode attention; out (B, 1, H, Dh).

    ``q_pos`` is the new token's position: an int, or an int32 tensor
    on ``q``'s device (the decode cache's ``length``), which the kernel
    reads on the device.
    """
    if _route(q) == "cuda":
        return decode_attention_fwd(q, k_cache, v_cache, q_pos,
                                    window=window, softcap=softcap)
    return ref.decode_attention_ref(q, k_cache, v_cache, q_pos,
                                    window=window, softcap=softcap)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, return_lse: bool = False):
    """Self-attention over positions ``0..S-1`` × ``0..T-1``; out
    (B, S, H, Dh) [, each row's log-sum-exp (B, S, H) float32]."""
    if _route(q) == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=return_lse)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=return_lse)


# ----------------------------------------------------------------------
# coded combine (eqs. 22/25/27) and the compressed hop's fused dequant
# ----------------------------------------------------------------------
def combine(coeff, grads) -> torch.Tensor:
    """out (R, F) = coeff (R, K) @ grads (K, F), float32."""
    if _route(grads) == "cuda":
        return coded_combine(coeff, grads)
    return ref.coded_combine_ref(coeff, grads)


def combine_q(coeff, grads_q, scales, block: int = 128) -> torch.Tensor:
    """int8 payload (K, F) dequantized by block, then ``coeff @ ·``."""
    if _route(grads_q) == "cuda":
        return coded_combine_q(coeff, grads_q, scales, block=block)
    return ref.coded_combine_q_ref(coeff, grads_q, scales, block)


def combine_q4(coeff, grads_q, scales, block: int = 128) -> torch.Tensor:
    """Packed int4 payload (K, F // 2) dequantized by block, then ``coeff @ ·``."""
    if _route(grads_q) == "cuda":
        return coded_combine_q4(coeff, grads_q, scales, block=block)
    return ref.coded_combine_q4_ref(coeff, grads_q, scales, block)


def combine_f8(coeff, grads_q, scales, block: int = 128) -> torch.Tensor:
    """fp8-e4m3 payload (K, F) dequantized by block, then ``coeff @ ·``."""
    if _route(grads_q) == "cuda":
        return coded_combine_f8(coeff, grads_q, scales, block=block)
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


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
