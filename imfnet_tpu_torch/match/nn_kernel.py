"""Kernel B: flash nearest-neighbour search (``csrc/flash_nn.cu``) and its
plain PyTorch version.

For each query, the nearest valid reference and the squared distance
``max(|q|² + |r|² − 2 q·r, 0)``; invalid references are never chosen, ties go
to the lowest index, and with no valid reference the result is (0, +inf).
Replaces ``imfnet_tpu/match/pallas_nn.py::nn_pallas``.

Masks: ``ref_valid`` (bool[M]) marks the references that may be chosen and
``query_valid`` (bool[N]) the queries that are searched; a query that is not
valid gets (0, +inf), the "no valid reference" result, whatever it holds.
Without a mask every row is valid. The kernel bounds its work by the masks
on the card, with no host read, so that one CUDA graph serves any counts:
its pre-pass reduces the span of the valid queries, [q_lo, q_hi), and of the
valid references, [r_lo, r_hi) (lowest and one past the highest valid row),
a block whose query tile misses [q_lo, q_hi) only stores, and the others
walk only the reference tiles that meet [r_lo, r_hi) (``NNPlan.part_ranges``
with the span). Padded rows at the end of a fixed capacity, as eval-kitti's
131 072 a side, cost no arithmetic; with every row valid the walk is the
whole one. Each call also tallies on the card the query × reference rows its
walked tiles cover, read only while tracing: the counters
``nn.rows_walked`` and ``nn.rows_full`` (N × M), ``utils.timer.count_device``.

The kernel gives a block of ``threads`` a ``bq × br`` tile of queries ×
references, each thread an 8 × 8 (or 4-wide) micro-tile of f32 dots in
registers, streams the reference tiles through a ``cp.async`` ring, and
splits a query tile's references over the ``split`` blocks of a thread-block
cluster, whose bests merge by (distance, lowest index). Each pair's
distance folds into a running (d, index) (``fold="pair"``, D = 32); at
D = 3, where that fold costs more than the dot, the ``"min"`` fold keeps a
running minimum alone and recovers the index by re-walking the one tile
that last lowered it. Every other width takes the ``"chunk"`` fold: D
zero-padded to a multiple of ``CHUNK_K`` (as the TPU kernel pads it), the
contraction staged ``CHUNK_K`` rows at a time, so its shared memory does
not grow with D, then the pair fold's (d, index) fold and merges.
``nn_plan`` chooses fold, tile and split from the shape; ``flash_nn`` is the port's entry point and ``run_plan`` launches a
given plan, for ``chip_smoke.py``'s sweep and the card tests.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from imfnet_tpu_torch.utils import cuda_build, launches, timer

KERNEL_DIMS = (3, 32)     # the widths with a fold of their own; any other D >= 1
                          # takes the chunk fold

# The plan, chosen from chip_smoke.py's sweep of every tile and split at
# 5000 x 5000 x 32 on the H100 (PERF.md):
NN_TILE = (64, 128, 128)  # queries x references of a block's tile, its threads
TARGET_BLOCKS = 200       # one wave: three such blocks fit each of the 132 SMs
MAX_SPLIT = 8             # portable thread-block cluster size
NN_STAGES = 3             # cp.async ring depth of the kernel
SCRATCH_PAD = 128         # rows of the kernel's k-major scratch are padded to this
SMEM_LIMIT = 227 * 1024   # the H100's shared memory per block (opt-in)
WORDS = 8                 # ints of a call's words: the spans, the walked rows' tally
# (bq, br, threads) of the (d, index) fold's instances in csrc/flash_nn.cu
# (D = 32): 128 threads with 8 x 8 dots each, or 256 threads with 8 x 8,
# 8 x 4, 4 x 8 or 4 x 4
NN_TILES = frozenset({(64, 128, 128), (128, 128, 256), (128, 64, 256), (64, 128, 256),
                      (64, 64, 256)})
# the min fold's instances (D = 3 only): (bq, br, threads) -> (queries,
# references) a thread and tile and the block's (rows, columns) of threads
# (TQ, TR, GY, GX in csrc/flash_nn.cu); each thread's queries stay in registers
NN_MIN_GEOMETRY = {(64, 128, 128): (8, 8, 8, 16), (128, 128, 256): (8, 8, 16, 16),
                   (128, 128, 128): (8, 16, 16, 8), (256, 128, 256): (8, 16, 32, 8),
                   (256, 128, 128): (16, 16, 16, 8)}
NN_MIN_TILES = frozenset(NN_MIN_GEOMETRY)
NN_MIN_TILE = (256, 128, 128)   # the D = 3 plan's tile: 16 x 16 a thread
# the chunk fold's instances (any D; 8 x 8 dots a thread) and its plan's tile
NN_CHUNK_TILES = frozenset({(64, 128, 128), (128, 128, 256)})
NN_CHUNK_TILE = (64, 128, 128)
CHUNK_K = 8               # rows of the contraction a stage of the chunk fold holds
FOLDS = ("pair", "min", "chunk")


class NNPlan(NamedTuple):
    """How kernel B runs one call: a block's tile of queries × references,
    its threads, the number of blocks of one cluster that share a query
    tile's references, and the fold (``FOLDS``)."""
    bq: int
    br: int
    threads: int
    split: int
    fold: str = "pair"

    def blocks(self, n: int) -> int:
        return -(-n // self.bq) * self.split

    def query_ranges(self, n: int) -> List[Tuple[int, int]]:
        """[start, stop) of the queries of each query tile."""
        return [(s, min(s + self.bq, n)) for s in range(0, n, self.bq)]

    def part_ranges(self, m: int, span: Optional[Tuple[int, int]] = None
                    ) -> List[Tuple[int, int]]:
        """[start, stop) of the references of each part, as the kernel walks
        them: the T reference tiles that meet ``span``, the valid
        references' [r_lo, r_hi) (every tile without one, none if it is
        empty), from tile t_lo = r_lo // br, part p taking tiles
        [t_lo + p·T/split, t_lo + (p+1)·T/split). A part may be empty."""
        lo, hi = (0, m) if span is None else span
        t_lo = lo // self.br
        tiles = -(-hi // self.br) - t_lo if hi > lo else 0
        return [(min((t_lo + p * tiles // self.split) * self.br, m),
                 min((t_lo + (p + 1) * tiles // self.split) * self.br, m))
                for p in range(self.split)]


def padded_width(d: int, fold: str) -> int:
    """The rows of components the kernel's k-major scratch holds: D, or D
    zero-padded to a multiple of ``CHUNK_K`` for the chunk fold."""
    return -(-d // CHUNK_K) * CHUNK_K if fold == "chunk" else d


def nn_smem_bytes(bq: int, br: int, d: int, fold: str = "pair") -> int:
    """Shared memory of one block (``NnTile``, ``Nn3Tile`` and
    ``NnkTile::smem_bytes`` in ``csrc/flash_nn.cu``): the ring of reference
    tiles, each row k-major with its squared norms, no smaller than the 16
    per-thread bests of every query row that reuse it, and one (d, index)
    per query; the pair fold also keeps the query tile there, the min fold
    its queries in registers. The chunk fold's ring stages ``CHUNK_K`` rows
    of the query and the reference tile and the references' norms, the same
    at every D."""
    if fold == "chunk":
        stage = CHUNK_K * bq + (CHUNK_K + 1) * br
        return (max(NN_STAGES * stage, 32 * bq) + 2 * bq) * 4
    ring = max(NN_STAGES * (d + 1) * br, 32 * bq)
    queries = (d + 1) * bq if fold == "pair" else 0
    return (queries + ring + 2 * bq) * 4


def built(plan: NNPlan, d: int) -> bool:
    """Whether csrc/flash_nn.cu has an instance for ``plan`` at width ``d``."""
    tiles = {"pair": NN_TILES if d == 32 else frozenset(),
             "min": NN_MIN_TILES if d == 3 else frozenset(),
             "chunk": NN_CHUNK_TILES if d >= 1 else frozenset()}
    return (plan.bq, plan.br, plan.threads) in tiles.get(plan.fold, frozenset())


def nn_plan(n: int, m: int, d: int) -> NNPlan:
    """Fold, tile and split for a call, from the shape alone (no device
    read).

    D = 3 takes the min fold in ``NN_MIN_TILE``, chosen from chip_smoke.py's
    sweep at the positive search's and ICP's shapes (where it beat every
    pair-fold tile, which D = 3 therefore no longer builds); D = 32 the
    pair fold in ``NN_TILE``, chosen from the sweep at 5000 × 5000 × 32;
    every other D the chunk fold in ``NN_CHUNK_TILE``, the same tile. ``n``
    queries give ``ceil(n / bq)`` query tiles, 40 at
    the main path's 5000, too few for 132 SMs; the references are split
    over the fewest blocks (at most ``MAX_SPLIT`` and the number of
    reference tiles) that give ``TARGET_BLOCKS`` blocks."""
    (bq, br, threads), fold = {3: (NN_MIN_TILE, "min"), 32: (NN_TILE, "pair")}.get(
        d, (NN_CHUNK_TILE, "chunk"))
    q_tiles = max(1, -(-n // bq))
    r_tiles = max(1, -(-m // br))
    split = min(-(-TARGET_BLOCKS // q_tiles), MAX_SPLIT, r_tiles)
    return NNPlan(bq, br, threads, split, fold)


def nn_plain(queries: torch.Tensor, refs: torch.Tensor,
             ref_valid: Optional[torch.Tensor] = None,
             query_valid: Optional[torch.Tensor] = None, *,
             block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the ``imfnet_tpu.match.nn.blocked_nn`` formula: per
    block of references, d² = |q|² + |r|² − 2 q·r, argmin within the block,
    strict ``<`` across blocks; (0, +inf) for a query that is not valid.
    Returns (idx int32[N], d2 f32[N])."""
    q = queries.float()
    r = refs.float()
    n, m = q.shape[0], r.shape[0]
    q_sq = (q * q).sum(dim=1, keepdim=True)
    best_d = torch.full((n,), float("inf"), device=q.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=q.device)
    for off in range(0, m, block):
        rb = r[off:off + block]
        d2 = q_sq + (rb * rb).sum(dim=1)[None, :] - 2.0 * (q @ rb.T)
        if ref_valid is not None:
            d2 = torch.where(ref_valid[None, off:off + block], d2,
                             torch.full_like(d2, float("inf")))
        loc_d, loc = d2.min(dim=1)
        better = loc_d < best_d
        best_d = torch.where(better, loc_d, best_d)
        best_i = torch.where(better, (loc + off).to(torch.int32), best_i)
    if query_valid is not None:
        best_i = torch.where(query_valid, best_i, torch.zeros_like(best_i))
        best_d = torch.where(query_valid, best_d, torch.full_like(best_d, float("inf")))
    return best_i, best_d.clamp_min(0.0)


def _check(q: torch.Tensor, r: torch.Tensor, valid: Optional[torch.Tensor],
           query_valid: Optional[torch.Tensor]) -> None:
    if q.dim() != 2 or r.dim() != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"flash_nn: want q[N,D], r[M,D]; got "
                         f"{tuple(q.shape)}, {tuple(r.shape)}")
    if q.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"flash_nn: q and r must be float32; got {q.dtype}, {r.dtype}")
    for mask, rows, name in ((valid, r.shape[0], "ref_valid must be bool[M]"),
                             (query_valid, q.shape[0], "query_valid must be bool[N]")):
        if mask is not None and (mask.dtype != torch.bool or mask.shape != (rows,)):
            raise ValueError(f"flash_nn: {name}")
    masks = [t for t in (valid, query_valid) if t is not None]
    if len({q.device, r.device} | {t.device for t in masks}) != 1:
        raise ValueError("flash_nn: q, r and the masks must share a device")
    for t in (q, r, *masks):
        if not t.is_contiguous():
            raise ValueError("flash_nn: inputs must be contiguous")


def flash_nn(queries: torch.Tensor, refs: torch.Tensor,
             ref_valid: Optional[torch.Tensor] = None,
             query_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32[N], d2 f32[N]). CUDA tensors launch kernel B in the plan
    ``nn_plan`` gives the shape (any D >= 1; the launch is counted in
    ``flash_nn.launches``); CPU tensors run the plain version."""
    _check(queries, refs, ref_valid, query_valid)
    if queries.device.type == "cpu":
        return nn_plain(queries, refs, ref_valid, query_valid)
    return run_plan(queries, refs, ref_valid,
                    nn_plan(queries.shape[0], refs.shape[0], queries.shape[1]),
                    query_valid=query_valid)


def run_plan(queries: torch.Tensor, refs: torch.Tensor,
             ref_valid: Optional[torch.Tensor], plan: NNPlan, *,
             query_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B on CUDA tensors in the given plan, counted in
    ``flash_nn.launches``; the walked rows' tally goes to the counters
    ``nn.rows_walked`` and ``nn.rows_full`` (``utils.timer.count_device``).
    A plan the kernel has no instance for raises. The port calls it through
    ``flash_nn``; ``chip_smoke.py``'s sweep and the card tests call it with
    plans of their own."""
    _check(queries, refs, ref_valid, query_valid)
    if queries.device.type != "cuda":
        raise ValueError(f"flash_nn: unsupported device {queries.device}; kernel B "
                         f"runs on CUDA tensors")
    n, d = queries.shape
    m = refs.shape[0]
    if d < 1:
        raise ValueError(f"flash_nn: the kernel serves D >= 1, got {d}")
    if (not built(plan, d) or not 1 <= plan.split <= MAX_SPLIT
            or nn_smem_bytes(plan.bq, plan.br, d, plan.fold) > SMEM_LIMIT):
        raise ValueError(f"flash_nn: no kernel instance for {plan} at D = {d}")
    out_i = torch.empty((n,), dtype=torch.int32, device=queries.device)
    out_d = torch.empty((n,), dtype=torch.float32, device=queries.device)
    if n == 0:
        return out_i, out_d
    rows = sum(-(-k // SCRATCH_PAD) * SCRATCH_PAD for k in (n, m))
    scratch = torch.empty(((padded_width(d, plan.fold) + 1) * rows,), dtype=torch.float32,
                          device=queries.device)
    words = torch.empty((WORDS,), dtype=torch.int32, device=queries.device)
    lib = _library()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_nn(
            queries.data_ptr(), refs.data_ptr(),
            None if ref_valid is None else ref_valid.data_ptr(),
            None if query_valid is None else query_valid.data_ptr(),
            scratch.data_ptr(), words.data_ptr(), out_i.data_ptr(), out_d.data_ptr(), n, m, d,
            plan.bq, plan.br, plan.threads, plan.split, FOLDS.index(plan.fold), stream)
        cuda_build.check(rc, "flash_nn")
        timer.count_device({"nn.rows_walked": words[4:6].view(torch.int64),
                            "nn.rows_full": n * m})
    launches.count(flash_nn)
    return out_i, out_d


flash_nn.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_nn")
    lib.flash_nn.restype = ctypes.c_int
    lib.flash_nn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib
