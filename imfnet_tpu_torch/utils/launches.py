"""Kernel launch counters.

Each kernel wrapper counts its launches in attributes of itself
(``flash_nn.launches``, ``gather_gemm.launches_tc``, ...) by calling
``count`` where it launches. While a stream is being captured into a CUDA
graph (``utils.graphs``), what is recorded on that stream, from whichever
thread (the autograd engine's thread records a captured backward), is
tallied for that capture alone (``tallied``) and not added to the
counters: the graph adds it once per replay (``add``). Launches on other
streams, such as another thread's eager work or replays beside the
capture, go on counting as they happen.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, Hashable, Iterator, Tuple

import torch

Counter = Tuple[Callable, str]      # (wrapper, attribute)

_captures: Dict[Hashable, Dict[Counter, int]] = {}   # capturing stream → its tally
_lock = threading.Lock()


def _stream_key() -> Hashable:
    """The stream the calling thread launches on."""
    return torch.cuda.current_stream().cuda_stream


def count(fn: Callable, attr: str = "launches") -> None:
    """One launch of ``fn``'s kernel: ``fn.<attr>`` += 1, or, on a stream
    inside ``tallied``, one more in that capture's tally."""
    with _lock:
        tally = _captures.get(_stream_key()) if _captures else None
        if tally is not None:
            tally[(fn, attr)] = tally.get((fn, attr), 0) + 1
        else:
            setattr(fn, attr, getattr(fn, attr) + 1)


def add(counts: Dict[Counter, int]) -> None:
    """``fn.<attr>`` += n for every ((fn, attr), n) of ``counts``."""
    with _lock:
        for (fn, attr), n in counts.items():
            setattr(fn, attr, getattr(fn, attr) + n)


@contextmanager
def tallied(stream: Hashable) -> Iterator[Dict[Counter, int]]:
    """{(fn, attr): launches} counted on ``stream`` (its ``cuda_stream``
    handle) inside the block, kept out of the counters."""
    tally: Dict[Counter, int] = {}
    with _lock:
        _captures[stream] = tally
    try:
        yield tally
    finally:
        with _lock:
            del _captures[stream]
