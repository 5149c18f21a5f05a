"""Streaming meters, wall-clock stopwatches (``imfnet_tpu.utils.timer``),
and the program's tracing: spans, counters and stage clocks.

Covers the reference's timing surface (`lib/timer.py`: per-phase averages in
train/eval loops, a min-of-runs timer for benchmarks) with one streaming
statistics class — count/mean/variance/min/max in a single `add` — and a
stopwatch wrapping it. These are host clocks: a lap around device work is the
time to enqueue it unless the lap ends in a read or a synchronize.
``device_trace`` records a profiler trace of a block of code.

Tracing is live while a ``torch.profiler`` records, or inside a
``tracing()`` block; otherwise each call below costs one flag test.

- ``span(name)``: a block of host work, named ``<module>.<stage>``, kept in
  memory as (name, parent, start_ns, end_ns) on the profiler's clock (unix
  nanoseconds) and, under a profiler, also opened as its
  ``record_function`` range, so that the trace shows it beside the device's
  work.
- ``count(name, n)``: a counter, named ``<module>.<stage>.<counter>`` after
  where the work happens (``pipeline.quantize.rows_valid``).
- ``count_device(counts)``: counters of one launch whose values the launch
  itself writes on the card (kernel B's walked rows, ``nn.rows_walked``):
  read once the work is done, never while tracing is off. Inside a capture
  the graph keeps them and each traced replay adds them, read with its
  stage times.
- ``stage(name)``: a stage boundary inside a CUDA graph
  (``utils.graphs``): a timing event captured into the graph at capture
  time, tracing or not, that starts stage ``name``; the stage runs to the
  next boundary or to the graph's end, which gets a timing event of its own
  in a graph that has stages. Outside a capture it does nothing. While
  tracing, the host reads a replay's stage times before the graph's next
  replay, and the last replay's at ``record()``.

``record()`` returns what was recorded so far; ``reset()`` clears it.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from typing import Dict, Hashable, Iterator, List, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _profiler


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


# the JAX package's min-of-runs timer: every Meter keeps its fastest lap (`.min`)
MinTimer = Timer


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the block (the counterpart of the JAX
    package's ``jax.profiler`` trace): host activity, and the card's where
    there is one, written on exit as one Chrome trace file under
    ``logdir``. The program's spans (``span``) open inside the block appear
    in it as ranges of their own name. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# -- the program's spans, counters and stage clocks ---------------------------

Span = Tuple[str, Optional[str], int, int]       # (name, parent, start_ns, end_ns)

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()       # .open: the calling thread's open span names
_tracing = 0                     # depth of open ``tracing()`` blocks
_spans: List[Span] = []
_counters: Dict[str, int] = {}
_stages: List[Dict] = []
_capturing: Dict[Hashable, "StageClock"] = {}   # capturing stream → its clock
_unread: Dict[int, Tuple["StageClock", int]] = {}  # id(clock) → (clock, launch ns)
_pending: List[Tuple[str, torch.Tensor]] = []   # eager device counters, read at record()
Counts = Dict[str, Union[int, torch.Tensor]]


def active() -> bool:
    """True while a profiler records or a ``tracing()`` block is open."""
    return bool(_tracing) or _profiler._is_profiler_enabled


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Spans, counters and stage times recorded inside the block, with no
    profiler running."""
    global _tracing
    with _lock:
        _tracing += 1
    try:
        yield
    finally:
        with _lock:
            _tracing -= 1


class _Span:
    __slots__ = ("name", "parent", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = (torch.profiler.record_function(self.name)
                      if _profiler._is_profiler_enabled else None)
        # stamped before the range opens and after it closes: the range's
        # own stamps fall inside, a few microseconds from these
        self.start = time.time_ns()
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        _local.open.pop()
        _spans.append((self.name, self.parent, self.start, end))
        return False


def span(name: str):
    """A context manager: the block as the span ``name`` while tracing is
    live (``active``), else a shared null context."""
    if not (_tracing or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """``name`` += n while tracing is live."""
    if _tracing or _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def _add(counts: Counts) -> None:
    """Adds ``counts`` to the counters, device values read (the caller
    holds the lock, and the work that writes them is done)."""
    for name, v in counts.items():
        _counters[name] = _counters.get(name, 0) + int(v)


class StageClock:
    """The stage boundaries captured into one CUDA graph: (stage name,
    timing event) in the graph's order, the first stage's to the graph's
    end (name None); empty in a graph without stages. ``counts``: the
    graph's device counters (``count_device``), one dict a launch."""

    def __init__(self, graph: str):
        self.graph = graph
        self.marks: List[Tuple[Optional[str], torch.cuda.Event]] = []
        self.counts: List[Counts] = []

    def mark(self, name: Optional[str]) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.marks.append((name, ev))

    def read(self) -> Dict[str, float]:
        """{stage: ms} of the graph's last replay, waiting for its end (a
        graph without stages: for the card)."""
        if not self.marks:
            torch.cuda.synchronize()
            return {}
        self.marks[-1][1].synchronize()
        ms: Dict[str, float] = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            ms[name] = ms.get(name, 0.0) + a.elapsed_time(b)
        return ms


@contextlib.contextmanager
def stage_clock(stream: Hashable, graph: str) -> Iterator[StageClock]:
    """The yielded clock of the CUDA graph ``graph`` captured on ``stream``
    (its ``cuda_stream`` handle) inside the block: the ``stage`` marks on
    that stream and, after the first, the block's end."""
    clock = StageClock(graph)
    with _lock:
        _capturing[stream] = clock
    try:
        yield clock
        if clock.marks:
            clock.mark(None)
    finally:
        with _lock:
            del _capturing[stream]


def stage(name: str) -> None:
    """Starts stage ``name`` of the CUDA graph being captured on the current
    stream; nothing outside a capture (eagerly, on the CPU)."""
    if not _capturing:
        return
    clock = _capturing.get(torch.cuda.current_stream().cuda_stream)
    if clock is not None:
        clock.mark(name)


def count_device(counts: Counts) -> None:
    """Counters of the launch just made: an int is added as given, a
    one-element integer tensor as the launch leaves it on the card. Inside
    a capture of ``utils.graphs`` the graph's clock keeps them for every
    traced replay; eagerly, while tracing, the ints are added now and the
    tensors (held until then) at ``record()``; otherwise nothing."""
    if _capturing:
        clock = _capturing.get(torch.cuda.current_stream().cuda_stream)
        if clock is not None:
            clock.counts.append(dict(counts))
            return
        if torch.cuda.is_current_stream_capturing():
            return            # another graph's capture: no replay of it is read
    if not (_tracing or _profiler._is_profiler_enabled):
        return
    with _lock:
        _add({k: v for k, v in counts.items() if not isinstance(v, torch.Tensor)})
        _pending.extend((k, v) for k, v in counts.items() if isinstance(v, torch.Tensor))


def _resolve(clock: StageClock, at_ns: int) -> None:
    ms = clock.read()
    if clock.marks:
        _stages.append({"graph": clock.graph, "at_ns": at_ns, "ms": ms,
                        "total_ms": sum(ms.values())})
    with _lock:
        for counts in clock.counts:
            _add(counts)


def before_replay(clock: StageClock) -> None:
    """Reads the clock's unread replay, before the next one rewrites it."""
    if _unread:
        with _lock:
            item = _unread.pop(id(clock), None)
        if item is not None:
            _resolve(*item)


def replayed(clock: StageClock) -> None:
    """A replay of the clock's graph has been launched: while tracing, its
    stage times and device counters are read later (``before_replay``,
    ``record``). A graph without either is not read."""
    if (clock.marks or clock.counts) and (_tracing or _profiler._is_profiler_enabled):
        with _lock:
            _unread[id(clock)] = (clock, time.time_ns())


def record() -> Dict:
    """{"spans": [(name, parent, start_ns, end_ns)], "counters": {name: n},
    "stages": [{"graph", "at_ns" (the replay's launch), "ms": {stage: ms},
    "total_ms"}] in launch order} recorded so far, the unread replays'
    stage times and the eager launches' device counters read first."""
    with _lock:
        unread = list(_unread.values())
        _unread.clear()
    for item in unread:
        _resolve(*item)
    with _lock:
        for name, v in _pending:
            _add({name: v})
        _pending.clear()
    return {"spans": list(_spans), "counters": dict(_counters),
            "stages": sorted(_stages, key=lambda s: s["at_ns"])}


def reset() -> None:
    """Forgets every span, counter and stage time recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _stages.clear()
        _unread.clear()
        _pending.clear()
