"""Spans and counters of the port: where a step's time goes, measured
where the work happens, while a ``torch.profiler`` records.

* :func:`span` ``(name)`` is a context manager.  It is on only while a
  torch profiler records (torch's own flag; under a profiler
  ``schedule`` that is the active steps, not the warm-up ones).  Off,
  it returns a shared do-nothing context at once: no profiler range, no
  event, no allocation, no autograd node.  On, it opens
  ``torch.profiler.record_function(name)`` (the span lies on the
  profiler's timeline), takes a host ``perf_counter_ns`` pair and, once
  CUDA is in use, records a pair of pooled timing events on the current
  stream (the card's clock).  Its tally keeps the calls ``n``, host ms,
  device ms and the name of the span open when it first started (its
  parent).  Around host-only work the device ms is the stream time
  between the two events: the idle that the host work costs the card
  once the card has drained.
* ``span(name, grad=True)`` yields ``(enter, exit)``: identity autograd
  functions for the region's inputs and outputs.  In the backward, the
  stretch from ``exit``'s backward to ``enter``'s is tallied as
  ``<name>.bwd``.  The autograd engine may run other ready nodes inside
  that stretch, so it is the region's backward plus whatever the engine
  interleaves.  With the span off, under ``inference_mode`` or with no
  input that requires grad, ``enter`` and ``exit`` return the very
  tensors they are given.
* :func:`recompute` marks a rematerialized layer's recomputation (the
  ``checkpoint`` recompute context): its time is tallied as
  :data:`REMAT` and taken out of every ``.bwd`` stretch that holds it,
  and the spans and counts inside it are not tallied again (their
  profiler ranges still open, so collectives stay on the timeline).
* :func:`count` ``(name, v)`` adds a host int or a 0-d device tensor
  (summed on the device, read only at :func:`snapshot`), on only while
  a profiler records and outside a recomputation; ``v`` may be a
  callable, so that a count computed on the device launches nothing
  where it would not be kept.
* The kernels' launch counters (:func:`register_launch`,
  :func:`launched`) count always, under their bare kernel names.

:func:`snapshot` flattens everything to ``span.<name>.n``,
``span.<name>.host_ms``, ``span.<name>.device_ms`` (CUDA only),
``count.<name>`` and the kernel names; with no profiler recording since
the last :func:`reset` it holds the kernel names alone.
``kernels.ops.launch_counts`` and ``reset_launch_counts`` are these two.

The tally is process-wide: on the card a backward runs on the autograd
engine's thread while the calling thread waits in it, and the spans it
opens nest under the caller's.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: the recomputation of a rematerialized layer (:func:`recompute`)
REMAT = "model.remat"


def recording() -> bool:
    """Whether a torch profiler records now."""
    flag = getattr(_autograd_profiler, "_is_profiler_enabled", None)
    if flag is None:
        return torch._C._autograd._profiler_enabled()
    return flag


class _Pair:
    """Two timing events around a stretch of the stream, less the
    stretches ``inner`` (recomputations inside a backward stretch)."""

    __slots__ = ("start", "end", "inner", "ms")

    def __init__(self):
        self.start, self.end, self.inner, self.ms = _event(), None, [], None

    def read(self) -> float:
        if self.ms is None:
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end) - sum(
                p.read() for p in self.inner)
        return self.ms


class _Tally:
    __slots__ = ("n", "host_ns", "device_ms", "pairs", "parent")

    def __init__(self, parent: Optional[str]):
        self.n, self.host_ns, self.device_ms = 0, 0, 0.0
        self.pairs: List[_Pair] = []
        self.parent = parent


_TALLY: Dict[str, _Tally] = {}
_COUNTS: Dict[str, object] = {}       # name → int, or a 0-d tensor
_LAUNCHES: Dict[str, int] = {}        # kernel name → launches
_OPEN: List[str] = []                 # the tallied spans open, innermost last
_BRACKETS: List["_Bracket"] = []      # backward stretches begun, not ended
_POOL: List["torch.cuda.Event"] = []  # timing events free for reuse
_quiet = 0                            # recomputations open


def _event():
    ev = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _add(name: str, parent: Optional[str], host_ns: int,
         pair: Optional[_Pair]) -> None:
    t = _TALLY.get(name)
    if t is None:
        t = _TALLY[name] = _Tally(parent)
    t.n += 1
    t.host_ns += host_ns
    if pair is not None:
        t.pairs.append(pair)


def _same(*xs):
    return xs[0] if len(xs) == 1 else xs


class _Off:
    """The span while no profiler records."""

    def __init__(self, grad: bool):
        self.value = (_same, _same) if grad else None

    def __enter__(self):
        return self.value

    def __exit__(self, *exc):
        return False


_OFF, _OFF_GRAD = _Off(False), _Off(True)


class _Bracket:
    """A region's backward: from ``exit``'s backward to ``enter``'s."""

    __slots__ = ("name", "parent", "rf", "t0", "pair", "inner_ns")

    def __init__(self, name: str):
        self.name, self.t0 = name, None

    def begin(self) -> None:
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.parent = _OPEN[-1] if _OPEN else None
        self.pair = _Pair() if torch.cuda.is_initialized() else None
        self.inner_ns = 0
        _BRACKETS.append(self)
        self.t0 = time.perf_counter_ns()

    def end(self) -> None:
        if self.t0 is None or self not in _BRACKETS:
            return
        t1 = time.perf_counter_ns()
        if self.pair is not None:
            self.pair.end = _event()
        _BRACKETS.remove(self)
        self.rf.__exit__(None, None, None)
        _add(self.name, self.parent, t1 - self.t0 - self.inner_ns, self.pair)


class _Mark(torch.autograd.Function):
    """The identity on ``xs``; its backward calls ``hook``."""

    @staticmethod
    def forward(ctx, hook, *xs):
        ctx.hook = hook
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.hook()
        return (None,) + gs


class _Span:
    """The span while a profiler records; ``tally`` False inside a
    recomputation (the profiler range alone)."""

    __slots__ = ("name", "grad", "tally", "remat", "rf", "parent", "pair",
                 "t0", "bracket")

    def __init__(self, name: str, grad: bool, tally: bool,
                 remat: bool = False):
        self.name, self.grad, self.tally, self.remat = (name, grad, tally,
                                                        remat)
        self.bracket = None

    def __enter__(self):
        global _quiet
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.tally:
            self.parent = _OPEN[-1] if _OPEN else None
            _OPEN.append(self.name)
            self.pair = _Pair() if torch.cuda.is_initialized() else None
            if self.remat:
                _quiet += 1
            self.t0 = time.perf_counter_ns()
        return (self.enter, self.exit) if self.grad else None

    def __exit__(self, *exc):
        global _quiet
        if self.tally:
            dt = time.perf_counter_ns() - self.t0
            if self.pair is not None:
                self.pair.end = _event()
            _OPEN.pop()
            if self.remat:
                _quiet -= 1
                for b in _BRACKETS:
                    b.inner_ns += dt
                    if b.pair is not None and self.pair is not None:
                        b.pair.inner.append(self.pair)
            _add(self.name, self.parent, dt, self.pair)
        self.rf.__exit__(*exc)
        return False

    def enter(self, *xs):
        if not (self.tally and torch.is_grad_enabled()
                and any(x.requires_grad for x in xs)):
            return _same(*xs)
        self.bracket = _Bracket(self.name + ".bwd")
        return _same(*_Mark.apply(self.bracket.end, *xs))

    def exit(self, *ys):
        if self.bracket is None or not torch.is_grad_enabled():
            return _same(*ys)
        return _same(*_Mark.apply(self.bracket.begin, *ys))


def span(name: str, grad: bool = False):
    """A span named ``name`` (see the module's docstring); with ``grad``
    it yields ``(enter, exit)``."""
    if not recording():
        return _OFF_GRAD if grad else _OFF
    return _Span(name, grad, tally=not _quiet)


def recompute():
    """The span of a rematerialized layer's recomputation."""
    if not recording():
        return _OFF
    return _Span(REMAT, False, tally=not _quiet, remat=True)


def count(name: str, v) -> None:
    """Add ``v`` (a host int or a 0-d tensor, or a callable returning
    one, called only when the count is kept) to the counter ``name``."""
    if not recording() or _quiet:
        return
    if callable(v):
        v = v()
    if isinstance(v, torch.Tensor):
        v = v.detach()
    have = _COUNTS.get(name)
    _COUNTS[name] = (v.clone() if isinstance(v, torch.Tensor) else v) \
        if have is None else have + v


def register_launch(name: str) -> None:
    """A kernel's launch counter, at 0."""
    _LAUNCHES.setdefault(name, 0)


def launched(name: str) -> None:
    """One launch of kernel ``name`` (counted whether or not a profiler
    records)."""
    _LAUNCHES[name] += 1


def snapshot() -> Dict[str, float]:
    """The kernels' launches, each tallied span's ``n``, ``host_ms`` and
    (CUDA) ``device_ms``, and each counter, since the last
    :func:`reset`.  Waits for the events it reads."""
    out: Dict[str, float] = dict(_LAUNCHES)
    for t in _TALLY.values():
        for p in t.pairs:
            p.read()
    for name, t in _TALLY.items():
        out[f"span.{name}.n"] = t.n
        out[f"span.{name}.host_ms"] = t.host_ns / 1e6
        if t.pairs or t.device_ms:
            t.device_ms += sum(p.ms for p in t.pairs)
            _release(t)
            out[f"span.{name}.device_ms"] = t.device_ms
    for name, v in _COUNTS.items():
        out[f"count.{name}"] = v.item() if isinstance(v, torch.Tensor) else v
    return out


def parents() -> Dict[str, Optional[str]]:
    """Each tallied span's parent: the span open when it first started
    (a backward stretch's: the span open when it began)."""
    return {name: t.parent for name, t in _TALLY.items()}


def _release(t: _Tally) -> None:
    for p in t.pairs:
        _POOL.append(p.start)
        _POOL.append(p.end)
        p.inner = []
    t.pairs = []


def reset() -> None:
    """Every tally, counter and kernel launch count back to nothing."""
    for t in _TALLY.values():
        _release(t)
    _TALLY.clear()
    _COUNTS.clear()
    _BRACKETS.clear()
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
