"""Public entry points over the port's kernels, dispatched by device.

A CUDA tensor launches the hand-written Hopper kernel, or the call
raises; a CPU tensor runs the kernel's plain version
(``kernels.ref``).  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd

#: every kernel wrapper of the port, by kernel name
KERNELS = {
    "decode_attention": decode_attention_fwd,
    "flash_attention": flash_attention_fwd,
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
                    softcap: float = 0.0) -> torch.Tensor:
    """Self-attention over positions ``0..S-1`` × ``0..T-1``; out (B, S, H, Dh)."""
    if _route(q) == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
