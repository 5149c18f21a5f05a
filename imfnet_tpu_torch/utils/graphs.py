"""The port's ``jax.jit``: a function of tensors captured once per input
signature as a CUDA graph, then replayed.

The JAX package compiles each program of its main path (the training step,
the validation step, a pair's registration) into one XLA executable that is
dispatched once a call. For a program that reads nothing back to the host,
a CUDA graph is that executable: ``jit(fn)`` returns a callable that, for
each signature of its arguments (the structure of tuples, lists, dicts and
NamedTuples, each tensor's shape, strides and dtype, which fields are None,
and the value of every other leaf),

- runs ``fn`` eagerly on a side stream at the first call (a real call,
  whose result is returned: kernels are built, plans chosen, optimizer
  state created),
- captures the next call into a CUDA graph with a private memory pool of
  its own, then replays the graph for that call and every later one, after
  copying each argument tensor into the graph's static copy of it. Tensors
  that are views of one buffer (a batch staged as one slab) keep that
  layout in the graph, and a call whose views lie in one buffer alike is
  copied in with one copy.

What ``fn`` must keep to:

- it reads nothing back to the host, and draws no random numbers: the
  caller draws outside, in the eager order, and passes the draws in;
- tensors it reads besides its arguments (parameters, buffers, optimizer
  state, a learning rate tensor) are read and written in place at every
  replay, so they must keep their storage;
- its result is made of tensors (in tuples, lists, dicts, NamedTuples) and
  None. A replay writes the same tensors again: clone what is kept past the
  next call, or ask ``jit(fn, clone=True)`` to return clones.

Kernel launch counters (``kernel_counters``) move at replay as they would in
an eager call: the launches recorded on a capture's stream are tallied for
it alone (``utils.launches``) and added once per replay. A capture that fails raises;
nothing falls back to eager.

Stage clocks (``utils.timer.stage_clock``): a capture marks each
``stage(name)`` it meets, and then the graph's end, with a timing event
inside the graph; a graph without stages holds no such event. The device
counters of its launches (``utils.timer.count_device``: kernel B's walked
rows) are kept with them. While tracing (``utils.timer.active``), a replay
is the span ``graphs.replay``, and its stage times and device counters are
read before the graph's next replay.

Threads: a capture runs in ``thread_local`` error mode, so another thread's
allocations and synchronizing calls (a loader's producer thread running its
own graphs or eager kernels) neither fail it nor are failed by it. One
``Graphed`` may be called from several threads: a lock holds its warm-up,
capture, copy-in, replay and, with ``clone``, the clones, and each replay
waits on the card for the one before it, whichever stream that ran on.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from imfnet_tpu_torch.utils import launches, timer


def kernel_counters() -> Tuple[launches.Counter, ...]:
    """Every kernel wrapper's launch counter: (wrapper, attribute). (The
    wrappers are imported here, not with the module: ``match`` imports
    this module for ICP.)"""
    from imfnet_tpu_torch.match.nn_kernel import flash_nn
    from imfnet_tpu_torch.sparse.conv_kernel import gather_gemm
    from imfnet_tpu_torch.sparse.map6_kernel import map6_many
    from imfnet_tpu_torch.sparse.quant_kernel import sorted_compact
    from imfnet_tpu_torch.sparse.word_map_kernel import word_match_many
    return ((gather_gemm, "launches"), (gather_gemm, "launches_tc"),
            (gather_gemm, "launches_cin1"), (gather_gemm, "launches_scalar"),
            (flash_nn, "launches"), (sorted_compact, "launches"),
            (word_match_many, "launches"), (gather_gemm, "launches_tcw"),
            (map6_many, "launches"))


def _read_counters() -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for fn, attr in kernel_counters())


def _leaf_key(leaf: Any):
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), leaf.stride(), leaf.dtype, leaf.device,
                leaf.requires_grad)
    try:
        hash(leaf)
    except TypeError:
        return ("object", id(leaf))   # the graph keeps the object, so the id stays its own
    return ("value", type(leaf), leaf)


def _byte_range(t: torch.Tensor) -> Tuple[int, int]:
    """[first, last + 1) bytes of t's storage that t's elements occupy."""
    es = t.element_size()
    first = t.storage_offset() * es
    if t.numel() == 0:
        return first, first
    return first, first + (sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1) * es


def _bytes_of(t: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """uint8[n]: bytes [first, first + n) of t's storage."""
    return torch.empty(0, dtype=torch.uint8, device=t.device).set_(
        t.untyped_storage(), first, (n,), (1,))


class _Slab:
    """Argument tensors that were views of one buffer at capture, kept as
    views of one static buffer at the same relative offsets."""

    def __init__(self, idx: List[int], leaves: List[torch.Tensor]):
        ranges = [_byte_range(leaves[i]) for i in idx]
        first = min(a for a, _ in ranges)
        self.idx = idx
        self.rel = tuple(a - first for a, _ in ranges)
        self.buf = torch.empty(max(b for _, b in ranges) - first, dtype=torch.uint8,
                               device=leaves[idx[0]].device)
        self.buf.copy_(_bytes_of(leaves[idx[0]], first, self.buf.numel()))
        self.views = [torch.empty(0, dtype=leaves[i].dtype, device=self.buf.device).set_(
            self.buf.untyped_storage(), r // leaves[i].element_size(), leaves[i].shape,
            leaves[i].stride()) for i, r in zip(idx, self.rel)]

    @staticmethod
    def fits(members: List[torch.Tensor]) -> bool:
        """Several views whose bytes cover at least half of their range, on
        offsets each type can start at."""
        ranges = [_byte_range(t) for t in members]
        first = min(a for a, _ in ranges)
        span = max(b for _, b in ranges) - first
        return (len(members) > 1 and 2 * sum(b - a for a, b in ranges) >= span
                and all((a - first) % t.element_size() == 0
                        for (a, _), t in zip(ranges, members)))

    def copy_in(self, leaves) -> None:
        src = [leaves[i] for i in self.idx]
        ranges = [_byte_range(t) for t in src]
        first = min(a for a, _ in ranges)
        ptr = src[0].untyped_storage().data_ptr()
        if (all(t.untyped_storage().data_ptr() == ptr for t in src)
                and tuple(a - first for a, _ in ranges) == self.rel):
            if ptr != self.buf.untyped_storage().data_ptr():
                self.buf.copy_(_bytes_of(src[0], first, self.buf.numel()))
            return
        for dst, t in zip(self.views, src):
            dst.copy_(t)


class _Graph:
    """One captured signature: the graph, its static inputs and outputs,
    and the kernel launches one replay makes."""

    def __init__(self, leaves: List[Any]):
        groups: Dict[int, List[int]] = {}
        for i, t in enumerate(leaves):
            if isinstance(t, torch.Tensor) and t.numel():
                groups.setdefault(t.untyped_storage().data_ptr(), []).append(i)
        self.static = list(leaves)     # the graph's arguments; other leaves as given
        self.slabs: List[_Slab] = []
        self.singles: List[int] = []
        for idx in groups.values():
            if _Slab.fits([leaves[i] for i in idx]):
                slab = _Slab(idx, leaves)
                self.slabs.append(slab)
                for i, v in zip(idx, slab.views):
                    self.static[i] = v
            else:
                self.singles.extend(idx)
                for i in idx:
                    self.static[i] = leaves[i].clone()
        for i, t in enumerate(leaves):   # empty tensors: nothing to copy in
            if isinstance(t, torch.Tensor) and not t.numel():
                self.static[i] = t.clone()
        self.graph = torch.cuda.CUDAGraph()
        self.out_leaves: List[Optional[torch.Tensor]] = []
        self.out_spec = None
        self.counts: Dict[launches.Counter, int] = {}
        self.clock: Optional[timer.StageClock] = None

    def copy_in(self, leaves) -> None:
        for slab in self.slabs:
            slab.copy_in(leaves)
        for i in self.singles:
            if self.static[i].data_ptr() != leaves[i].data_ptr():
                self.static[i].copy_(leaves[i])


class Graphed:
    """``fn`` behind one CUDA graph per argument signature (``jit``)."""

    def __init__(self, fn: Callable, clone: bool = False):
        self.fn = fn
        self.clone = clone
        self.graphs: Dict[Any, _Graph] = {}
        self._warm: set = set()      # signatures whose eager warm-up has run
        self._stream: Optional[torch.cuda.Stream] = None
        self._lock = threading.Lock()
        self._done: Optional[torch.cuda.Event] = None   # the last replay's end
        self.replays = 0      # replays of any of this function's graphs
        self.captures = 0

    def __call__(self, *args):
        leaves, spec = tree_flatten(args)
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        if not tensors:
            raise ValueError("jit: the arguments hold no tensor")
        for t in tensors:
            if t.device.type != "cuda":
                raise ValueError(f"jit: a CUDA graph takes CUDA tensors, got one on {t.device}")
        key = (spec, tuple(_leaf_key(x) for x in leaves))
        with self._lock:
            entry = self.graphs.get(key)
            if entry is None:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(tensors[0].device)
                if key not in self._warm:
                    self._warm.add(key)
                    return self._on_side_stream(args)
                entry = self.graphs[key] = self._capture(leaves, spec)
                self.captures += 1
            stream = torch.cuda.current_stream(tensors[0].device)
            if self._done is not None:     # a replay on another stream has ended
                stream.wait_event(self._done)
            timer.before_replay(entry.clock)
            with timer.span("graphs.replay"):
                entry.copy_in(leaves)
                entry.graph.replay()
                launches.add(entry.counts)
                self.replays += 1
                out = [t.clone() if self.clone and t is not None else t
                       for t in entry.out_leaves]
            timer.replayed(entry.clock)
            self._done = torch.cuda.Event()
            self._done.record(stream)
        return tree_unflatten(out, entry.out_spec)

    def _on_side_stream(self, args):
        side, main = self._stream, torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        main.wait_stream(side)
        return out

    def _capture(self, leaves, spec) -> _Graph:
        entry = _Graph(leaves)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream())
        # the capture launched nothing: what is counted on its stream (the
        # backward's launches from autograd's thread too) is a replay's
        name = getattr(self.fn, "__qualname__", type(self.fn).__name__)
        with launches.tallied(side.cuda_stream) as tally, \
                torch.cuda.graph(entry.graph, stream=side, capture_error_mode="thread_local"), \
                timer.stage_clock(side.cuda_stream, name) as clock:
            out = self.fn(*tree_unflatten(entry.static, spec))
        entry.counts, entry.clock = tally, clock
        torch.cuda.current_stream().wait_stream(side)
        entry.out_leaves, entry.out_spec = tree_flatten(out)
        for t in entry.out_leaves:
            if t is not None and not isinstance(t, torch.Tensor):
                raise TypeError(f"jit: a graph's result holds tensors and None, not "
                                f"{type(t).__name__}")
        return entry

    def launches_per_replay(self) -> Dict[str, int]:
        """{"wrapper.attribute": launches} of one replay of each graph,
        summed over this function's graphs (one graph: its launches a
        call)."""
        return {f"{fn.__name__}.{attr}": sum(g.counts.get((fn, attr), 0)
                                             for g in self.graphs.values())
                for fn, attr in kernel_counters()}


def jit(fn: Callable, *, clone: bool = False) -> Graphed:
    """``fn`` captured as a CUDA graph per argument signature and replayed
    (see the module's docstring); with ``clone`` a replay returns clones of
    the graph's outputs, made under its lock. Raises for arguments off the
    card."""
    return Graphed(fn, clone)
