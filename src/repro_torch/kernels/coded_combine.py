"""Hopper coded-combine kernels: wrappers over ``csrc/coded_combine.cu``.

``out (R, F) = C (R, K) @ G (K, F)`` in float32, with the payload's
dequantization fused in.  Four wrappers, one per Pallas kernel of
``repro/kernels/coded_combine.py`` they replace:

  * :func:`coded_combine`     — G float32 (eq. 22 encode, eqs. 25/27 decode),
  * :func:`coded_combine_q`   — G int8 × one f32 scale per ``block`` values,
  * :func:`coded_combine_q4`  — G packed int4 (K, F/2) bytes × scale,
  * :func:`coded_combine_f8`  — G float8_e4m3fn × scale.

The source's header says what bounds them and how they are laid out.
The plain versions are ``kernels.ref.coded_combine*_ref``.  Any F and
any ``block`` that divides the payload; nothing is padded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build

KIND = {"f32": 0, "int8": 1, "int4": 2, "fp8": 3}
PAYLOAD_DTYPE = {"f32": torch.float32, "int8": torch.int8,
                 "int4": torch.int8, "fp8": torch.float8_e4m3fn}
#: bytes a vector load of each kind reads (the alignment it needs)
_VEC_BYTES = {"f32": 16, "int8": 16, "int4": 8, "fp8": 16}
#: the most C a launch takes, in floats (kinds 1–3 keep it in shared
#: memory; the f32 kernel reads it through the read-only cache)
MAX_COEFFS = 48 * 1024


def _lib():
    lib = build.load("coded_combine")
    fn = lib.coded_combine_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, P, I, I, P, L, P, L, L, L, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def _launch(kind: str, coeff: torch.Tensor, grads: torch.Tensor,
            scales, block: int, F: int) -> torch.Tensor:
    if not (coeff.is_cuda and grads.device == coeff.device
            and (scales is None or scales.device == coeff.device)):
        raise ValueError("coded_combine needs CUDA tensors on one device")
    if coeff.dtype != torch.float32 or coeff.ndim != 2:
        raise ValueError(f"coeff must be (R, K) float32, got "
                         f"{tuple(coeff.shape)} {coeff.dtype}")
    R, K = coeff.shape
    if grads.ndim != 2 or grads.shape[0] != K:
        raise ValueError(f"grads {tuple(grads.shape)} do not match coeff "
                         f"{tuple(coeff.shape)}")
    if grads.dtype != PAYLOAD_DTYPE[kind]:
        raise ValueError(f"{kind} payload must be {PAYLOAD_DTYPE[kind]}, "
                         f"got {grads.dtype}")
    if grads.stride(1) != 1:
        raise ValueError("grads rows must be packed")
    if R * K > MAX_COEFFS:
        raise ValueError(f"C has {R * K} coefficients; a launch takes at "
                         f"most {MAX_COEFFS}")
    s_rs = 0
    if scales is not None:
        if scales.dtype != torch.float32 or scales.shape != (K, F // block) \
                or scales.stride(1) != 1:
            raise ValueError(f"scales must be packed ({K}, {F // block}) "
                             f"float32, got {tuple(scales.shape)} "
                             f"{scales.dtype}")
        s_rs = scales.stride(0)
    coeff = coeff.contiguous()
    out = torch.empty((R, F), dtype=torch.float32, device=coeff.device)
    if F == 0:
        return out
    align = _VEC_BYTES[kind]
    row_bytes = grads.stride(0) * grads.element_size()
    vec_ok = int(grads.data_ptr() % align == 0 and row_bytes % align == 0)
    err = _lib()(
        KIND[kind], coeff.data_ptr(), R, K, grads.data_ptr(),
        grads.stride(0), None if scales is None else scales.data_ptr(),
        s_rs, int(block), int(F), out.data_ptr(), vec_ok,
        torch.cuda.current_stream(coeff.device).cuda_stream,
    )
    build.check(err, f"coded_combine ({kind})")
    return out


def _check_block(F: int, block: int) -> None:
    if block < 1 or F % block:
        raise ValueError(f"block {block} must divide the payload's "
                         f"{F} values")


def coded_combine(coeff: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """out (R, F) = coeff (R, K) @ grads (K, F), float32 (FMA, no TF32)."""
    out = _launch("f32", coeff, grads, None, 1, grads.shape[-1])
    obs.launched("coded_combine")
    return out


def coded_combine_q(coeff, grads_q, scales, block: int = 128):
    """Fused int8 dequant combine: grads_q (K, F) int8, scales
    (K, F // block) float32."""
    F = grads_q.shape[-1]
    _check_block(F, block)
    out = _launch("int8", coeff, grads_q, scales, block, F)
    obs.launched("coded_combine_q")
    return out


def coded_combine_q4(coeff, grads_q, scales, block: int = 128):
    """Fused packed-int4 dequant combine: grads_q (K, F // 2) int8 bytes
    (value 2i in the low nibble of byte i), scales (K, F // block)."""
    F = 2 * grads_q.shape[-1]
    _check_block(F, block)
    if block % 2:
        raise ValueError(f"int4 needs an even block, got {block}")
    out = _launch("int4", coeff, grads_q, scales, block, F)
    obs.launched("coded_combine_q4")
    return out


def coded_combine_f8(coeff, grads_q, scales, block: int = 128):
    """Fused fp8-e4m3 dequant combine: grads_q (K, F) float8_e4m3fn."""
    F = grads_q.shape[-1]
    _check_block(F, block)
    out = _launch("fp8", coeff, grads_q, scales, block, F)
    obs.launched("coded_combine_f8")
    return out


for _name in ("coded_combine", "coded_combine_q", "coded_combine_q4",
              "coded_combine_f8"):
    obs.register_launch(_name)
