"""Streaming meters and wall-clock stopwatches (``imfnet_tpu.utils.timer``).

Covers the reference's timing surface (`lib/timer.py`: per-phase averages in
train/eval loops, a min-of-runs timer for benchmarks) with one streaming
statistics class — count/mean/variance/min/max in a single `add` — and a
stopwatch wrapping it. These are host clocks: a lap around device work is the
time to enqueue it unless the lap ends in a read or a synchronize.
``device_trace`` records a profiler trace of a block of code.
"""
from __future__ import annotations

import contextlib
import math
import os
import time


class Meter:
    """Streaming scalar statistics (Welford): mean/var/min/max/total/last."""

    __slots__ = ("count", "mean", "_m2", "min", "max", "last")

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = 0.0

    def add(self, value: float, weight: int = 1):
        """Fold in ``weight`` identical observations of ``value`` in O(1)
        (Chan's parallel-variance merge with a zero-variance group)."""
        if weight <= 0:
            return float(value)
        value = float(value)
        self.last = value
        new_count = self.count + weight
        delta = value - self.mean
        self.mean += delta * weight / new_count
        self._m2 += delta * delta * weight * self.count / new_count
        self.count = new_count
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        return value

    @property
    def total(self) -> float:
        return self.mean * self.count

    @property
    def var(self) -> float:
        return self._m2 / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.var)

    def __repr__(self):
        return (f"Meter(n={self.count}, mean={self.mean:.6g}, "
                f"std={self.std:.3g}, min={self.min:.6g}, max={self.max:.6g})")


class Stopwatch(Meter):
    """A Meter fed by wall-clock laps. Use tic()/toc() or as a context
    manager; every lap lands in the inherited statistics."""

    __slots__ = ("_t0",)

    def __init__(self):
        super().__init__()
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        lap = time.perf_counter() - self._t0
        self.add(lap)
        return self.mean if average else lap

    def __enter__(self):
        self.tic()
        return self

    def __exit__(self, *exc):
        self.toc()
        return False


# -- reference-API spellings (`lib/timer.py` call sites use these names) ----

class Timer(Stopwatch):
    """Stopwatch under the reference's name; `.avg`/`.diff` spellings."""

    @property
    def avg(self) -> float:
        return self.mean

    @property
    def diff(self) -> float:
        return self.last

    @property
    def total_time(self) -> float:
        return self.total


class AverageMeter(Meter):
    """Meter under the reference's name; `.update`/`.avg`/`.val` spellings."""

    def update(self, val: float, n: int = 1):
        self.add(val, weight=n)

    @property
    def avg(self) -> float:
        return self.mean

    @property
    def val(self) -> float:
        return self.last


class MinTimer(Timer):
    """Stopwatch whose headline number is the fastest lap (benchmarks)."""
    # `.min` is inherited from Meter


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the block (the counterpart of the JAX
    package's ``jax.profiler`` trace): host activity, and the card's where
    there is one, written on exit as one Chrome trace file under
    ``logdir``. Yields the profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
