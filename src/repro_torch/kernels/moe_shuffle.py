"""Hopper MoE shuffle kernels: wrappers over ``csrc/moe_shuffle.cu``.

The token permutation of ``models/moe.py`` into and out of the experts'
slots, as four gathers over the plan of ``models.moe.shuffle_plan``
(``src``: each slot's entry ``t·k + j`` or −1; ``slot_tk``: each
entry's slot or −1):

  * :func:`moe_dispatch`     — ``buf[s] = x[src[s] // k]``, zeros where empty;
  * :func:`moe_combine`      — ``y[t] = Σ_j w[t, j] · out[slot_tk[t, j]]``;
  * :func:`moe_dispatch_bwd` — ``dx[t] = Σ_j dbuf[slot_tk[t, j]]``;
  * :func:`moe_combine_bwd`  — ``dout[s] = w[e] · dy[e // k]`` and
    ``dw[e] = ⟨dy[e // k], out[s]⟩`` for ``e = src[s]``, zeros for empty
    slots and dropped entries.

No pass has an atomic; each output row is written once.  The two passes
that fill the slots visit them in token order, so that a token's row is
read once for its k copies.  The source's
header says what bounds them and how they are laid out.  The plain
version is ``kernels.ref.moe_dispatch_ref`` / ``moe_combine_ref`` with
PyTorch's autograd; ``kernels.ops`` wraps these four in the autograd
Functions the layer calls on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import DTYPE_CODES


def _lib():
    lib = build.load("moe_shuffle")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
            ("moe_dispatch_launch", [I, P, L, P, P, I, I, I, I, I, I, P, P]),
            ("moe_gather_sum_launch", [I, P, L, P, P, I, I, I, I, I, P, P]),
            ("moe_combine_bwd_launch",
             [I, P, L, P, L, P, P, P, I, I, I, I, I, I, P, P, P])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def threads_per_row(d: int, vec: int) -> int:
    """The group of threads that moves one row of ``d`` values ``vec`` at
    a time: the largest power of two up to a warp that has a vector for
    each of its threads."""
    n = max(1, d // vec)
    return 1 << min(5, n.bit_length() - 1)


def _vec(d: int, *rows: torch.Tensor) -> int:
    """Values a vector load moves: 16 bytes where ``d`` fills whole
    vectors and every base pointer and row stride is 16-byte aligned,
    else one."""
    size = rows[0].element_size()
    vec = 16 // size
    ok = d % vec == 0 and all(
        t.data_ptr() % 16 == 0 and (t.stride(0) * size) % 16 == 0
        for t in rows)
    return vec if ok else 1


def _check(what: str, dtype: torch.dtype, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{what} needs CUDA tensors on one device")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: rows must be float32 or bfloat16, got "
                         f"{dtype}")


def _index(t: torch.Tensor, n: int, what: str) -> None:
    if t.dtype != torch.int32 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{what} must be {n} packed int32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _rows(t: torch.Tensor, d: int, what: str) -> None:
    if t.ndim != 2 or t.shape[1] != d or t.stride(1) != 1:
        raise ValueError(f"{what} must be (rows, {d}) with packed rows, got "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _weights(w: torch.Tensor, n: int) -> None:
    if w.dtype != torch.float32 or w.numel() != n or not w.is_contiguous():
        raise ValueError(f"the weights must be {n} packed float32, got "
                         f"{tuple(w.shape)} {w.dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def moe_dispatch(x: torch.Tensor, slot_tk: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``x`` (N, d) → the slots (n_slots, d): ``x[src[s] // k]``, zero
    where ``src[s] < 0`` (each kept entry ``t·k + j`` fills its slot
    ``slot_tk[t, j]``)."""
    N, k = slot_tk.shape
    _check("moe_dispatch", x.dtype, x, slot_tk, src)
    d = x.shape[-1]
    _rows(x, d, "x")
    if x.shape[0] != N:
        raise ValueError(f"x has {x.shape[0]} tokens, slot_tk {N}")
    n_slots = src.numel()
    _index(slot_tk, N * k, "slot_tk")
    _index(src, n_slots, "src")
    buf = torch.empty((n_slots, d), dtype=x.dtype, device=x.device)
    if n_slots and d:
        vec = _vec(d, x, buf)
        err = _lib().moe_dispatch_launch(
            DTYPE_CODES[x.dtype], x.data_ptr(), x.stride(0),
            slot_tk.data_ptr(), src.data_ptr(), N, n_slots, k, d,
            threads_per_row(d, vec), int(vec > 1), buf.data_ptr(),
            _stream(x))
        build.check(err, "moe_dispatch")
    obs.launched("moe_dispatch")
    return buf


def _gather_sum(rows: torch.Tensor, slot_tk: torch.Tensor, w, what: str
                ) -> torch.Tensor:
    N, k = slot_tk.shape
    _check(what, rows.dtype, rows, slot_tk,
           *(() if w is None else (w,)))
    d = rows.shape[-1]
    _rows(rows, d, "rows")
    _index(slot_tk, N * k, "slot_tk")
    if w is not None:
        _weights(w, N * k)
    y = torch.empty((N, d), dtype=rows.dtype, device=rows.device)
    if N and d:
        vec = _vec(d, rows, y)
        err = _lib().moe_gather_sum_launch(
            DTYPE_CODES[rows.dtype], rows.data_ptr(), rows.stride(0),
            slot_tk.data_ptr(), None if w is None else w.data_ptr(), N, k, d,
            threads_per_row(d, vec), int(vec > 1), y.data_ptr(),
            _stream(rows))
        build.check(err, what)
    obs.launched(what)
    return y


def moe_combine(out: torch.Tensor, w: torch.Tensor,
                slot_tk: torch.Tensor) -> torch.Tensor:
    """The experts' rows ``out`` (n_slots, d), the weights ``w`` (N, k)
    float32 and ``slot_tk`` (N, k) → y (N, d):
    ``Σ_j w[t, j] · out[slot_tk[t, j]]`` over the kept j, in order."""
    return _gather_sum(out, slot_tk, w, "moe_combine")


def moe_dispatch_bwd(dbuf: torch.Tensor, slot_tk: torch.Tensor
                     ) -> torch.Tensor:
    """The slots' gradient ``dbuf`` (n_slots, d) → dx (N, d):
    ``Σ_j dbuf[slot_tk[t, j]]`` over the kept j, in order."""
    return _gather_sum(dbuf, slot_tk, None, "moe_dispatch_bwd")


def moe_combine_bwd(dy: torch.Tensor, out: torch.Tensor, w: torch.Tensor,
                    slot_tk: torch.Tensor, src: torch.Tensor):
    """The combine's backward in one pass: → (dout (n_slots, d) in
    ``out``'s dtype, dw (N, k) float32)."""
    N, k = slot_tk.shape
    _check("moe_combine_bwd", out.dtype, dy, out, w, slot_tk, src)
    d = out.shape[-1]
    if dy.dtype != out.dtype:
        raise ValueError(f"dy is {dy.dtype}, the rows {out.dtype}")
    _rows(dy, d, "dy")
    _rows(out, d, "out")
    n_slots = out.shape[0]
    _index(slot_tk, N * k, "slot_tk")
    _index(src, n_slots, "src")
    _weights(w, N * k)
    dout = torch.empty((n_slots, d), dtype=out.dtype, device=out.device)
    dw = torch.empty((N, k), dtype=torch.float32, device=out.device)
    if n_slots and d:
        vec = _vec(d, dy, out, dout)
        err = _lib().moe_combine_bwd_launch(
            DTYPE_CODES[out.dtype], dy.data_ptr(), dy.stride(0),
            out.data_ptr(), out.stride(0), w.data_ptr(), slot_tk.data_ptr(),
            src.data_ptr(), N, n_slots, k, d, threads_per_row(d, vec),
            int(vec > 1), dout.data_ptr(), dw.data_ptr(), _stream(out))
        build.check(err, "moe_combine_bwd")
    obs.launched("moe_combine_bwd")
    return dout, dw


for _name in ("moe_dispatch", "moe_combine", "moe_dispatch_bwd",
              "moe_combine_bwd"):
    obs.register_launch(_name)
