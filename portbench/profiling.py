"""The traced part of a ``--trace 1`` run, reduced to plain records.

Two passes.  The first runs a warm-up step or batch that the profiler's
schedule discards (a session can lack the device records of its first
kernels), then a few more under a device-only trace: CUDA activity, no
host ops recorded and no synchronization between them beyond what the
step itself does (a training step reads its loss, a batch its tokens),
as in the window.  The device metrics, the busy time and the window come
from it; the busy time is the union of the device intervals (kernels on
several streams overlap, so their sum can exceed it).  The second pass
runs one more step under a host and device trace, whose host ops name
the idle gaps of the ``breakdown`` and nothing else: recording every
host op slows the host, and with it the idle share.  Either pass comes
back as ``(name, start_us, end_us)`` records.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Tuple

Interval = Tuple[str, float, float]


def union_s(device: List[Interval]) -> float:
    """Seconds covered by the union of the intervals."""
    total, until = 0.0, None
    for _, s, e in sorted(device, key=lambda r: r[1]):
        if until is None or s > until:
            total += e - s
            until = e
        elif e > until:
            total += e - until
            until = e
    return total / 1e6


def gaps(device: List[Interval]) -> List[Tuple[float, float]]:
    """The idle stretches (start_us, end_us) between device work."""
    out, until = [], None
    for _, s, e in sorted(device, key=lambda r: r[1]):
        if until is not None and s > until:
            out.append((until, s))
        until = e if until is None else max(until, e)
    return out


def kernel_ms(device: List[Interval], match: Callable[[str], bool]) -> float:
    """Device milliseconds of the operations whose name ``match``es."""
    return sum(e - s for n, s, e in device if match(n)) / 1e3


def breakdown(t: Dict) -> Dict:
    """The ten device operations of the device-only pass that took most
    time, and the ten longest idle gaps of the host pass, each named by
    the innermost host op running in it."""
    by_name: Dict[str, float] = collections.Counter()
    for n, s, e in t["device"]:
        by_name[n[:160]] += (e - s) / 1e6
    idle = sorted(gaps(t["host_device"]), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in idle:
        mid = (s + e) / 2
        inside = [h for h in t["host"] if h[1] <= mid <= h[2]]
        what = min(inside, key=lambda h: h[2] - h[1])[0] if inside \
            else "(no host op)"
        named.append([what[:160], (e - s) / 1e6])
    return {"device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": named}


def _records(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device, host) records of a finished profiler."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append(rec)
        else:
            host.append(rec)
    return device, host


def profile(step: Callable[[], None], n: int, sync: Callable) -> Dict:
    """Run ``step`` once as warm-up and ``n`` times under the device-only
    trace, then once under the host trace → ``{"device", "window_s",
    "launches", "steps"}`` of the first pass (``launches``: the port's
    kernel launch counters over its ``n`` steps) and ``{"host",
    "host_device"}`` of the second."""
    import torch
    from torch.profiler import ProfilerActivity, schedule

    from repro_torch.kernels import ops

    # the n steps make one profiler step: a prof.step() between two of
    # them would put a boundary there that the window does not have.  With
    # no card (the tests on the CPU) the profiler wants some activity: the
    # host's, which yields no device records
    only = ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU
    with torch.profiler.profile(
            activities=[only],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        step()
        sync()
        prof.step()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        window = time.perf_counter() - t0
        launches = dict(ops.launch_counts())
        prof.step()
    device, _ = _records(prof)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        step()
        sync()
    host_device, host = _records(prof)
    return {"device": device, "window_s": window, "launches": launches,
            "steps": n, "host": host, "host_device": host_device}


def idle_pct(t) -> "float | None":
    """Share of the traced window with no device operation running, %."""
    if not t or not t["device"]:
        return None
    return 100.0 * (1.0 - union_s(t["device"]) / t["window_s"])


_DISPATCH = ("sort", "index", "scatter", "gather", "searchsorted")
_ELEMENTWISE = ("elementwise_kernel", "reduce_kernel", "multi_tensor_apply",
                "catarraybatchedcopy")


def is_dispatch(name: str) -> bool:
    """PyTorch's sort, searchsorted, gather, scatter and index kernels."""
    n = name.lower()
    return any(p in n for p in _DISPATCH)


def is_elementwise(name: str) -> bool:
    """PyTorch's elementwise, copy and reduce kernels (not indexing)."""
    n = name.lower()
    return any(p in n for p in _ELEMENTWISE) and not is_dispatch(name)


def is_flash(name: str) -> bool:
    return "flash_fwd" in name


def is_decode(name: str) -> bool:
    return "decode_attn_kernel" in name


def is_combine(name: str) -> bool:
    """The quantized combine (``combine_f32_kernel`` is the f32 one)."""
    return "combine_kernel" in name and "combine_f32_kernel" not in name


def roofline_pct(t, counter: str, match: Callable[[str], bool],
                 bounds: List[float]) -> "float | None":
    """Σ ``bounds`` (ms, one a launch) over the matching kernels' device
    ms, %; None unless the program's launch counter, the trace's records
    and ``bounds`` agree on the number of launches."""
    launches = t["launches"].get(counter, 0)
    seen = sum(1 for n, _, _ in t["device"] if match(n))
    if not launches or launches != seen or launches != len(bounds):
        return None
    return 100.0 * sum(bounds) / kernel_ms(t["device"], match)
