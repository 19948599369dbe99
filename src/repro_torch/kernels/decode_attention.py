"""Hopper decode-attention kernel: wrapper over ``csrc/decode_attention.cu``.

Single-token GQA decode over the ring-buffer KV cache; replaces the
Pallas kernel ``repro/kernels/decode_attention.py:decode_attention_fwd``.
The source's header says what bounds it and how it is laid out: the
cache sweep of each (sequence, kv head) is split across ``n_split``
blocks (:func:`split_plan`), whose partial softmax states the last block
to finish merges.  The plain version is
``kernels.ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16
MAX_SPLIT = 64       # the kernel's bound on n_split
SPLIT_ALIGN = 16     # a split's slot count is a multiple of this
BLOCKS_PER_SM = 2    # the grid the plan aims for

#: per device: the merge's per-(b, kvh) int32 counters, zero between launches
_COUNTERS: dict = {}


def _lib():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                       L, L, L, L, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def split_plan(C: int, n_groups: int, n_sm: int) -> tuple:
    """``(n_split, chunk)``: the cache sweep of each of the ``n_groups``
    (sequence, kv head) pairs is cut into ``n_split`` ranges of ``chunk``
    slots (the last one shorter, none empty), so that the grid of
    ``n_groups × n_split`` blocks is about ``BLOCKS_PER_SM`` blocks per
    SM.  A pure function of the shapes and the card, never of ``q_pos``,
    so it needs no host sync; ``n_split = 1`` when the groups alone fill
    the card."""
    if C < 1 or n_groups < 1 or n_sm < 1:
        raise ValueError(f"split_plan({C}, {n_groups}, {n_sm})")
    if n_groups >= n_sm:
        return 1, C
    want = min(MAX_SPLIT, -(-BLOCKS_PER_SM * n_sm // n_groups))
    chunk = -(-C // want)
    chunk = -(-chunk // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-C // chunk), chunk


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _check_rows_aligned(t: torch.Tensor, dims) -> None:
    """The kernels copy rows of Dh features with 16-byte vector loads."""
    size = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(d) * size % 16 for d in dims):
        raise ValueError("the kernel needs 16-byte aligned rows: base "
                         "pointer and the strides of "
                         f"dims {tuple(dims)} ({t.stride()})")


def decode_attention_fwd(
    q: torch.Tensor,        # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, C, Kv, Dh)
    v_cache: torch.Tensor,  # (B, C, Kv, Dh)
    q_pos,                  # int, or int32 device tensor with one element
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the CUDA kernel; out (B, 1, H, Dh) in ``q``'s dtype.

    ``k_cache``/``v_cache`` may be strided in their batch and slot
    dimensions (e.g. a view of the decode cache's ``(B, C, Kv·Dh)``
    buffer); heads and features must be packed.  ``q_pos`` as a device
    tensor is read by the kernel itself (no host sync).  Launches on the
    current stream; the merge counters are shared by the launches on one
    device, so launches must not run concurrently on two streams.
    """
    B, one, H, Dh = q.shape
    C, Kv = k_cache.shape[1], k_cache.shape[2]
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError("decode_attention_fwd needs CUDA tensors on one "
                         "device")
    if one != 1 or k_cache.shape != (B, C, Kv, Dh) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    if q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}: need float32 or bfloat16 for "
                         f"all three")
    if H % Kv:
        raise ValueError(f"H={H} not a multiple of Kv={Kv}")
    G = H // Kv
    if Dh not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"kernel takes Dh in {HEAD_DIMS} and G <= "
                         f"{MAX_GROUP}, got Dh={Dh}, G={G}")
    for t in (k_cache, v_cache):
        if t.stride(3) != 1 or t.stride(2) != Dh:
            raise ValueError("cache heads/features must be packed")
        _check_rows_aligned(t, (0, 1))
    if q.requires_grad:
        raise ValueError("decode_attention_fwd is forward only")
    q = q.contiguous()
    if isinstance(q_pos, torch.Tensor):
        if q_pos.device != q.device or q_pos.dtype != torch.int32 \
                or q_pos.numel() != 1:
            raise ValueError("q_pos must be one int32 on q's device")
    else:
        q_pos = torch.tensor(int(q_pos), dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split, chunk = split_plan(C, B * Kv, n_sm)
    part = counter = None
    if n_split > 1:
        part = torch.empty(B * Kv * n_split * G * (Dh + 2),
                           dtype=torch.float32, device=q.device)
        counter = _counters(q.device, B * Kv)
    err = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), q_pos.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counter is None else counter.data_ptr(),
        DTYPE_CODES[q.dtype], B, Kv, G, C, Dh, chunk, n_split,
        k_cache.stride(0), k_cache.stride(1), v_cache.stride(0),
        v_cache.stride(1), int(window), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "decode_attention")
    obs.launched("decode_attention")
    return out


obs.register_launch("decode_attention")
