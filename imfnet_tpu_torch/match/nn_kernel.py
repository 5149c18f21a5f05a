"""Kernel B: flash nearest-neighbour search (``csrc/flash_nn.cu``) and its
plain PyTorch version.

For each query, the nearest valid reference and the squared distance
``max(|q|² + |r|² − 2 q·r, 0)``; invalid references are never chosen, ties go
to the lowest index, and with no valid reference the result is (0, +inf).
Replaces ``imfnet_tpu/match/pallas_nn.py::nn_pallas``.

The kernel gives a block of ``threads`` a ``bq × br`` tile of queries ×
references, each thread an 8 × 8 (or 4-wide) micro-tile of f32 dots in
registers, streams the reference tiles through a ``cp.async`` ring, and
splits a query tile's references over the ``split`` blocks of a thread-block
cluster, whose bests merge by (distance, lowest index). Each pair's
distance folds into a running (d, index) (``fold="pair"``, D = 32); at
D = 3, where that fold costs more than the dot, the ``"min"`` fold keeps a
running minimum alone and recovers the index by re-walking the one tile
that last lowered it. ``nn_plan`` chooses fold, tile and split from the
shape; ``flash_nn`` is the port's entry point and ``run_plan`` launches a
given plan, for ``chip_smoke.py``'s sweep and the card tests.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from imfnet_tpu_torch.utils import cuda_build

KERNEL_DIMS = (3, 32)

# The plan, chosen from chip_smoke.py's sweep of every tile and split at
# 5000 x 5000 x 32 on the H100 (PERF.md):
NN_TILE = (64, 128, 128)  # queries x references of a block's tile, its threads
TARGET_BLOCKS = 200       # one wave: three such blocks fit each of the 132 SMs
MAX_SPLIT = 8             # portable thread-block cluster size
NN_STAGES = 3             # cp.async ring depth of the kernel
SCRATCH_PAD = 128         # rows of the kernel's k-major scratch are padded to this
SMEM_LIMIT = 227 * 1024   # the H100's shared memory per block (opt-in)
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
FOLDS = ("pair", "min")


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

    def part_ranges(self, m: int) -> List[Tuple[int, int]]:
        """[start, stop) of the references of each part: part p walks the
        reference tiles [p·T/split, (p+1)·T/split) of the T tiles, as the
        kernel does. A part may be empty."""
        tiles = -(-m // self.br)
        return [(min(p * tiles // self.split * self.br, m),
                 min((p + 1) * tiles // self.split * self.br, m))
                for p in range(self.split)]


def nn_smem_bytes(bq: int, br: int, d: int, fold: str = "pair") -> int:
    """Shared memory of one block (``NnTile::smem_bytes`` and
    ``Nn3Tile::smem_bytes`` in ``csrc/flash_nn.cu``): the ring of reference
    tiles, each row k-major with its squared norms, no smaller than the 16
    per-thread bests of every query row that reuse it, and one (d, index)
    per query; the pair fold also keeps the query tile there, the min fold
    its queries in registers."""
    ring = max(NN_STAGES * (d + 1) * br, 32 * bq)
    queries = (d + 1) * bq if fold == "pair" else 0
    return (queries + ring + 2 * bq) * 4


def built(plan: NNPlan, d: int) -> bool:
    """Whether csrc/flash_nn.cu has an instance for ``plan`` at width ``d``."""
    tiles = {"pair": NN_TILES if d == 32 else frozenset(),
             "min": NN_MIN_TILES if d == 3 else frozenset()}
    return (plan.bq, plan.br, plan.threads) in tiles.get(plan.fold, frozenset())


def nn_plan(n: int, m: int, d: int) -> NNPlan:
    """Fold, tile and split for a call, from the shape alone (no device
    read).

    D = 3 takes the min fold in ``NN_MIN_TILE``, chosen from chip_smoke.py's
    sweep at the positive search's and ICP's shapes (where it beat every
    pair-fold tile, which D = 3 therefore no longer builds); D = 32 the
    pair fold in ``NN_TILE``, chosen from the sweep at 5000 × 5000 × 32. ``n`` queries give ``ceil(n / bq)`` query tiles, 40 at
    the main path's 5000, too few for 132 SMs; the references are split
    over the fewest blocks (at most ``MAX_SPLIT`` and the number of
    reference tiles) that give ``TARGET_BLOCKS`` blocks."""
    (bq, br, threads), fold = (NN_MIN_TILE, "min") if d == 3 else (NN_TILE, "pair")
    q_tiles = max(1, -(-n // bq))
    r_tiles = max(1, -(-m // br))
    split = min(-(-TARGET_BLOCKS // q_tiles), MAX_SPLIT, r_tiles)
    return NNPlan(bq, br, threads, split, fold)


def nn_plain(queries: torch.Tensor, refs: torch.Tensor,
             ref_valid: Optional[torch.Tensor] = None, *,
             block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the ``imfnet_tpu.match.nn.blocked_nn`` formula: per
    block of references, d² = |q|² + |r|² − 2 q·r, argmin within the block,
    strict ``<`` across blocks. Returns (idx int32[N], d2 f32[N])."""
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
    return best_i, best_d.clamp_min(0.0)


def _check(q: torch.Tensor, r: torch.Tensor, valid: Optional[torch.Tensor]) -> None:
    if q.dim() != 2 or r.dim() != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"flash_nn: want q[N,D], r[M,D]; got "
                         f"{tuple(q.shape)}, {tuple(r.shape)}")
    if q.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"flash_nn: q and r must be float32; got {q.dtype}, {r.dtype}")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (r.shape[0],)):
        raise ValueError("flash_nn: ref_valid must be bool[M]")
    devices = {q.device, r.device} | ({valid.device} if valid is not None else set())
    if len(devices) != 1:
        raise ValueError("flash_nn: q, r and ref_valid must share a device")
    for t in (q, r, valid):
        if t is not None and not t.is_contiguous():
            raise ValueError("flash_nn: inputs must be contiguous")


def flash_nn(queries: torch.Tensor, refs: torch.Tensor,
             ref_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32[N], d2 f32[N]). CUDA tensors launch kernel B in the plan
    ``nn_plan`` gives the shape (D must be 3 or 32; the launch is counted in
    ``flash_nn.launches``); CPU tensors run the plain version."""
    _check(queries, refs, ref_valid)
    if queries.device.type == "cpu":
        return nn_plain(queries, refs, ref_valid)
    return run_plan(queries, refs, ref_valid,
                    nn_plan(queries.shape[0], refs.shape[0], queries.shape[1]))


def run_plan(queries: torch.Tensor, refs: torch.Tensor,
             ref_valid: Optional[torch.Tensor], plan: NNPlan
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B on CUDA tensors in the given plan, counted in
    ``flash_nn.launches``. A plan the kernel has no instance for raises. The
    port calls it through ``flash_nn``; ``chip_smoke.py``'s sweep and the
    card tests call it with plans of their own."""
    _check(queries, refs, ref_valid)
    if queries.device.type != "cuda":
        raise ValueError(f"flash_nn: unsupported device {queries.device}; kernel B "
                         f"runs on CUDA tensors")
    n, d = queries.shape
    m = refs.shape[0]
    if d not in KERNEL_DIMS:
        raise ValueError(f"flash_nn: the kernel serves D in {KERNEL_DIMS}, got {d}")
    if (not built(plan, d) or not 1 <= plan.split <= MAX_SPLIT
            or nn_smem_bytes(plan.bq, plan.br, d, plan.fold) > SMEM_LIMIT):
        raise ValueError(f"flash_nn: no kernel instance for {plan} at D = {d}")
    out_i = torch.empty((n,), dtype=torch.int32, device=queries.device)
    out_d = torch.empty((n,), dtype=torch.float32, device=queries.device)
    if n == 0:
        return out_i, out_d
    rows = sum(-(-k // SCRATCH_PAD) * SCRATCH_PAD for k in (n, m))
    scratch = torch.empty(((d + 1) * rows,), dtype=torch.float32, device=queries.device)
    lib = _library()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_nn(
            queries.data_ptr(), refs.data_ptr(),
            None if ref_valid is None else ref_valid.data_ptr(),
            scratch.data_ptr(), out_i.data_ptr(), out_d.data_ptr(), n, m, d,
            plan.bq, plan.br, plan.threads, plan.split, FOLDS.index(plan.fold), stream)
    cuda_build.check(rc, "flash_nn")
    flash_nn.launches += 1
    return out_i, out_d


flash_nn.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_nn")
    lib.flash_nn.restype = ctypes.c_int
    lib.flash_nn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib
