"""A bounded profiled window and what it holds.

``profiled(fn, n)`` runs ``fn(i)`` for units 0..n-1 under ``torch.profiler``
(host and device activity) inside a ``bench.window`` range, and returns a
``Trace``: every device interval (kernels, copies, sets) with its name, the
harness's own ranges (``bench.*``, from ``span``), and the window's bounds,
all on the profiler's clock. The trace stays in memory; nothing is written.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

Interval = Tuple[int, int]          # [start_ns, end_ns)


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    kind: str                        # "kernel", "memcpy" or "memset"


class Trace(NamedTuple):
    ops: List[DeviceOp]
    spans: List[Tuple[str, int, int]]  # harness ranges: (name, start_ns, end_ns)
    window: Interval
    units: int


def _ns(e, attr: str) -> int:
    return int(getattr(e, attr)())


def union_ns(intervals: List[Interval]) -> int:
    """Length of the union of half-open intervals: overlapping time counted
    once."""
    total, end = 0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: List[Interval], window: Interval) -> List[Interval]:
    """The stretches of ``window`` that no interval covers."""
    out, at = [], window[0]
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, window[1])))
        at = max(at, b)
        if at >= window[1]:
            break
    if at < window[1]:
        out.append((at, window[1]))
    return [g for g in out if g[1] > g[0]]


def clip(ops: List[DeviceOp], window: Interval) -> List[Interval]:
    return [(max(o.start_ns, window[0]), min(o.end_ns, window[1])) for o in ops
            if o.end_ns > window[0] and o.start_ns < window[1]]


def _kind(name: str) -> str:
    low = name.lower()
    if "memcpy" in low:
        return "memcpy"
    if "memset" in low:
        return "memset"
    return "kernel"


def profiled(fn: Callable[[int], None], n: int) -> Trace:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
    ops, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = _ns(e, "start_ns"), _ns(e, "duration_ns")
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("bench.") or e.is_user_annotation() or dur <= 0:
                continue
            ops.append(DeviceOp(name, start, start + dur, _kind(name)))
        elif name.startswith("bench."):
            if name == "bench.window":
                window = (start, start + dur)
            else:
                spans.append((name, start, start + dur))
    if window is None:
        raise RuntimeError("trace: the profiler recorded no bench.window range")
    if not ops:
        raise RuntimeError("trace: the profiler recorded no device activity")
    return Trace(ops, spans, window, n)


class Spans:
    """Host-clock spans of the harness, per unit: ``with spans("call"):``
    adds the block's seconds under ``call`` and, while a profiler runs,
    marks it as the range ``bench.call``."""

    def __init__(self):
        self.seconds = {}
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        import time
        rf = (torch.profiler.record_function(f"bench.{name}") if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


def innermost(spans, t: int) -> Optional[str]:
    """Name of the shortest harness range holding time ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t < b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return None if best is None else best[0]


def breakdown(tr: Trace, top: int = 10):
    """{"device_ops": [[name, s]], "idle_gaps": [[span, s]]}: the device
    operations that took most time in the window, and its longest idle
    stretches named by the harness range open when each began."""
    per = {}
    for o in tr.ops:
        a, b = max(o.start_ns, tr.window[0]), min(o.end_ns, tr.window[1])
        if b > a:
            per[o.name] = per.get(o.name, 0) + (b - a)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    g = sorted(gaps(clip(tr.ops, tr.window), tr.window), key=lambda ab: ab[0] - ab[1])[:top]
    return {"device_ops": [[n[:120], v / 1e9] for n, v in ops],
            "idle_gaps": [[innermost(tr.spans, a) or "outside a harness span", (b - a) / 1e9]
                          for a, b in g]}
