"""Hopper flash-attention forward kernel: wrapper over
``csrc/flash_attention.cu``.

Causal / sliding-window / softcapped GQA self-attention over positions
``0..S-1`` × ``0..T-1``; replaces the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention_fwd`` (with its GQA
fold ``flash_attention_gqa``).  The source's header says what bounds it
and how it is laid out.  The plain version is
``kernels.ref.flash_attention_ref``.  Forward only: training wraps it
in ``models.attention.FlashAttention`` (a ``torch.autograd.Function``
whose backward is the reference's recompute backward in PyTorch ops),
and asks it for each row's log-sum-exp, which that backward needs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    DTYPE_CODES,
    HEAD_DIMS,
    _check_rows_aligned,
)

#: the C entry's code for a TMA descriptor the CUDA driver refused
TENSOR_MAP_ERROR = 1000


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, I, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, T, Kv, Dh)
    v: torch.Tensor,  # (B, T, Kv, Dh)
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    return_lse: bool = False,
):
    """Launch the CUDA kernel; out (B, S, H, Dh) in ``q``'s dtype, and
    with ``return_lse`` also each row's log-sum-exp (B, S, H) float32.

    Batch and sequence dimensions may be strided; heads and features
    must be packed.  bf16 runs on the tensor cores (rows 16-byte
    aligned): Dh 64, 128 and 256 on the wgmma kernel, whose TMA
    descriptors the C entry builds from these strides, Dh 16 and 32 on
    the mma.sync kernel; float32 runs on the f32 FMA kernel, never
    through TF32.  Other head sizes raise.
    """
    B, S, H, Dh = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd needs CUDA tensors on one "
                         "device")
    if k.shape != (B, T, Kv, Dh) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         f"float32 or bfloat16 for all three")
    if H % Kv or Dh not in HEAD_DIMS:
        raise ValueError(f"kernel takes H % Kv == 0 and Dh in {HEAD_DIMS}, "
                         f"got H={H}, Kv={Kv}, Dh={Dh}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_attention_fwd is forward only; train "
                         "through models.attention.FlashAttention")
    for t in (q, k, v):
        if t.stride(3) != 1 or t.stride(2) != Dh:
            raise ValueError("heads/features must be packed")
        if t.dtype == torch.bfloat16:  # the tensor-core kernel's vector loads
            _check_rows_aligned(t, (0, 1))
    out = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        DTYPE_CODES[q.dtype], B, S, T, H, Kv, Dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        int(bool(causal)), int(window), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err == TENSOR_MAP_ERROR:
        raise RuntimeError("flash_attention: the CUDA driver refused a TMA "
                           "descriptor (cuTensorMapEncodeTiled) for strides "
                           f"q {q.stride()} k {k.stride()} v {v.stride()}")
    build.check(err, "flash_attention")
    obs.launched("flash_attention")
    return (out, lse) if return_lse else out


obs.register_launch("flash_attention")
