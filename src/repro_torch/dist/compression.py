"""Blockwise gradient compression for the edge→master hop.

PyTorch counterpart of ``repro.dist.compression``: the same three
codecs under one contract — flat payload padded to a block multiple,
one f32 scale per block, exact-zero pad region — so the fused dequant
combine kernels (:mod:`repro_torch.kernels.coded_combine`) consume any
of them:

  ========  ======================  ==================  ==============
  mode      payload                 bytes per value     scale formula
  ========  ======================  ==================  ==============
  int8      int8, one per value     1                   max|x| / 127
  int4      two nibbles per int8    0.5 (packed)        max|x| / 7
  fp8       float8_e4m3fn           1                   max|x| / 448
  ========  ======================  ==================  ==============

Payload and scales equal the reference's bit for bit: the same f32
divisions, ``torch.round`` rounds half to even as ``jnp.round`` does,
and fp8 converts with round-to-nearest-even into ``torch.float8_e4m3fn``.

Pad invariant: the pad positions are masked out of each block's max, so
they never move a scale, and they quantize to exactly 0.

Error feedback (:func:`compress_error_feedback`) keeps the time-averaged
transmitted gradient unbiased for every codec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import _tree

PyTree = Any

DEFAULT_BLOCK = 256

#: symmetric quantization range per codec (max representable magnitude)
_QMAX = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}

COMPRESSION_MODES = tuple(_QMAX)


@dataclasses.dataclass(frozen=True)
class QuantMeta:
    """Static shape info needed to undo a blockwise quantizer."""

    shape: Tuple[int, ...]
    block: int
    pad: int
    mode: str = "int8"


def _blocked(x: torch.Tensor, block: int):
    """Flatten + zero-pad to a block multiple; per-block max |x| with the
    pad positions masked out of the reduction (the pad invariant)."""
    x = x.to(torch.float32)
    shape = tuple(x.shape)
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    mags = blocks.abs()
    if pad:
        # the pad is zeros, so |pad| = 0 already never raises a max; the
        # explicit mask keeps the rule visible, as the reference writes it
        mags.reshape(-1)[n:] = 0.0
    amax = mags.amax(dim=1)
    return blocks, amax, shape, pad


def _scaled(blocks, amax, qmax: float):
    scales = amax / qmax
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    return blocks / safe[:, None], scales


def quantize_int8(x, block: int = DEFAULT_BLOCK):
    """Blockwise symmetric int8: ``(q, scales, meta)``; ``q`` flat and
    zero-padded to a block multiple, ``scales`` one f32 per block."""
    blocks, amax, shape, pad = _blocked(x, block)
    v, scales = _scaled(blocks, amax, 127.0)
    q = v.round_().clamp_(-127, 127).to(torch.int8)
    return q.reshape(-1), scales, QuantMeta(shape, block, pad, "int8")


def dequantize_int8(q, scales, meta: QuantMeta):
    blocks = q.reshape(-1, meta.block).to(torch.float32)
    flat = (blocks * scales[:, None]).reshape(-1)
    return flat[: flat.numel() - meta.pad].reshape(meta.shape)


# ----------------------------------------------------------------------
# int4: two nibbles per int8 byte
# ----------------------------------------------------------------------
def pack_int4(vals: torch.Tensor) -> torch.Tensor:
    """Pack an even-length int vector in [-8, 7] into nibbles: element 2i
    in the LOW nibble of byte i, element 2i+1 in the HIGH nibble."""
    v = vals.to(torch.int32) & 0xF
    lo, hi = v[0::2], v[1::2]
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → int32 values in [-8, 7]."""
    p = packed.view(torch.uint8).to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(-1)


def quantize_int4(x, block: int = DEFAULT_BLOCK):
    """Blockwise symmetric packed int4: ``(q_packed, scales, meta)``;
    ``block`` must be even (nibble pairs never straddle a block)."""
    if block % 2:
        raise ValueError(f"int4 needs an even block, got {block}")
    blocks, amax, shape, pad = _blocked(x, block)
    v, scales = _scaled(blocks, amax, 7.0)
    q = v.round_().clamp_(-7, 7).to(torch.int32)
    return pack_int4(q.reshape(-1)), scales, QuantMeta(shape, block, pad,
                                                        "int4")


def dequantize_int4(q_packed, scales, meta: QuantMeta):
    vals = unpack_int4(q_packed).to(torch.float32)
    flat = (vals.reshape(-1, meta.block) * scales[:, None]).reshape(-1)
    return flat[: flat.numel() - meta.pad].reshape(meta.shape)


# ----------------------------------------------------------------------
# fp8 (e4m3): blockwise-scaled float payload
# ----------------------------------------------------------------------
def quantize_fp8(x, block: int = DEFAULT_BLOCK):
    """Blockwise-scaled fp8-e4m3: ``(q_f8, scales, meta)``; the scale maps
    each block's max |x| onto e4m3's max normal, 448."""
    blocks, amax, shape, pad = _blocked(x, block)
    v, scales = _scaled(blocks, amax, 448.0)
    q = v.to(torch.float8_e4m3fn)
    return q.reshape(-1), scales, QuantMeta(shape, block, pad, "fp8")


def dequantize_fp8(q, scales, meta: QuantMeta):
    blocks = q.to(torch.float32).reshape(-1, meta.block)
    flat = (blocks * scales[:, None]).reshape(-1)
    return flat[: flat.numel() - meta.pad].reshape(meta.shape)


# ----------------------------------------------------------------------
# mode dispatch
# ----------------------------------------------------------------------
_QUANTIZE = {"int8": quantize_int8, "int4": quantize_int4,
             "fp8": quantize_fp8}
_DEQUANTIZE = {"int8": dequantize_int8, "int4": dequantize_int4,
               "fp8": dequantize_fp8}


def quantize(x, block: int = DEFAULT_BLOCK, mode: str = "int8"):
    """Blockwise quantize under any codec: ``(payload, scales, meta)``."""
    try:
        fn = _QUANTIZE[mode]
    except KeyError:
        raise ValueError(f"unknown compression mode {mode!r} "
                         f"(choose from {COMPRESSION_MODES})") from None
    return fn(x, block=block)


def dequantize(q, scales, meta: QuantMeta):
    """Inverse of :func:`quantize` — the codec rides ``meta.mode``."""
    return _DEQUANTIZE[meta.mode](q, scales, meta)


def wire_bytes_per_value(mode: str, block: int = DEFAULT_BLOCK) -> float:
    """Cross-pod bytes per gradient value (payload + amortized scales)."""
    payload = {"int8": 1.0, "int4": 0.5, "fp8": 1.0}[mode]
    return payload + 4.0 / block


# ----------------------------------------------------------------------
# tree wrappers
# ----------------------------------------------------------------------
def quantize_tree(tree: PyTree, block: int = DEFAULT_BLOCK,
                  mode: str = "int8") -> PyTree:
    """Quantize every leaf into a ``{"q", "scales", "meta"}`` dict."""

    def one(x):
        q, s, meta = quantize(x, block=block, mode=mode)
        return {"q": q, "scales": s, "meta": meta}

    return _tree.map(one, tree)


def dequantize_tree(qtree: PyTree, like: PyTree) -> PyTree:
    """Inverse of :func:`quantize_tree` over ``like``'s structure."""
    return _tree.map(lambda _, d: dequantize(d["q"], d["scales"], d["meta"]),
                     like, qtree)


def init_pod_residuals(tree: PyTree, n_pods: int) -> PyTree:
    """Zero EF residuals, one row per pod: leaves ``(n_pods, *shape)``
    float32 for every codec, so a residual restores under any mode."""
    return _tree.map(
        lambda x: torch.zeros((n_pods,) + tuple(x.shape),
                              dtype=torch.float32, device=x.device), tree)


def compress_error_feedback(tree: PyTree, residual: PyTree,
                            block: int = DEFAULT_BLOCK, mode: str = "int8"
                            ) -> Tuple[PyTree, PyTree]:
    """One EF-SGD round: quantize ``tree + residual``; the new residual is
    what the payload failed to carry, so transmitted values telescope.
    Returns ``(q_tree, new_residual)``."""
    target = _tree.map(lambda g, r: g + r, tree, residual)
    qtree = quantize_tree(target, block=block, mode=mode)
    sent = dequantize_tree(qtree, target)
    new_residual = _tree.map(lambda t, s: t - s, target, sent)
    return qtree, new_residual
