"""Kernel A: the sparse-conv gather-GEMM (``csrc/sparse_conv.cu``) and its
plain PyTorch version.

    out f32[n_out, cout] = Σ_k x[nbr[i, k]] @ W[k]      (nbr = -1 → 0)

Replaces the TPU kernels of ``imfnet_tpu/sparse/pallas_conv.py``
(``banded_conv_pallas_union``, ``banded_conv_pallas_planned`` and their jit
wrapper ``banded_conv_pallas``): one function, so one kernel, in four
variants that ``conv_plan`` chooses between from dtype and shape:

- ``"tc"``: bf16 operands with ``cin`` and ``cout`` multiples of 8 and
  16-byte aligned ``x`` and ``w`` (every conv of the main path). Tensor
  cores (``mma.sync`` bf16 → f32), ``cp.async``-staged gathers, a
  ``bm × bn`` tile per block, ``bk`` input channels a step, the live
  offsets split over ``split`` blocks of one cluster.
- ``"tcw"``: the same tile where its ``[bm, k_vol]`` map block would not
  fit a block's shared memory (the 6-D k3 convs of ``eval.dgr``, k_vol
  729): the map block is staged ``WK_CHUNK`` offsets at a time and each
  chunk's live offsets are walked through the same ring. Each launch
  tallies on the card the (row tile × live offset) steps it walked, as
  ``bm`` rows each, and the live entries of the map
  (``conv.slots_walked``, ``conv.entries_live``, beside the map's
  ``conv.map_slots``, N_out × k_vol; ``utils.timer.count_device``).
- ``"cin1"``: one input channel, bf16 or f32, at any alignment (conv1 of
  every training step and of SimpleNet, k 125): one thread per output row
  with 32 f32 accumulators (a wider ``cout`` in passes of 32), the block's
  ``[bm, k_vol]`` map block and the pass's ``W[:, 0, :]`` staged in shared
  memory, one gathered scalar per offset, summed in offset order.
- ``"scalar"``: everything else (f32 operands at ``cin > 1``, other widths,
  and a cin = 1 ``k_vol`` whose map block would not fit a block's shared
  memory): f32 FMAs on a 64 × 64 tile.

``gather_gemm`` is the port's entry point; ``run_plan`` launches a given
plan, for ``conv_sweep.py`` and the card tests.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from imfnet_tpu_torch.utils import cuda_build, launches, timer

_DTYPES = (torch.bfloat16, torch.float32)

# The tensor-core plan, chosen from conv_sweep.py's tables on the H100 (every
# tile, input-channel step and split at each main-path shape; PERF.md):
TC_BM = 128               # output rows per tile (4 warps of 32 rows)
TARGET_BLOCKS = 256       # about two per SM (132), counted on capacities
MAX_STEPS = 64            # (offset, input slice) steps one block walks at most
MAX_SPLIT = 8             # portable thread-block cluster size
WIDE_MACS = 128 * 256     # cin * cout from which a 128-wide tile steps 64 channels
TC_STAGES = 4             # cp.async ring depth of the kernel
SMEM_LIMIT = 227 * 1024   # the H100's shared memory per block (opt-in)
# (bm, bn, bk) of the tensor-core instances in csrc/sparse_conv.cu
TC_TILES = frozenset({(TC_BM, 32, 32), (TC_BM, 64, 32), (TC_BM, 128, 32),
                      (TC_BM, 128, 64)})
SCALAR_TILE = (64, 64, 32)
CIN1_BN = 32              # output channels of one pass of the cin = 1 variant
CIN1_BMS = (128, 64, 32)  # its rows (threads) a block, the most that fit first
WK_CHUNK = 128            # offsets of the map block the wide-K tile stages at a time
_VARIANTS = {"scalar": 0, "tc": 1, "cin1": 2, "tcw": 3}


class ConvPlan(NamedTuple):
    """How kernel A runs one call: variant, output tile (rows × channels),
    input channels per step, and the number of blocks its live offsets are
    split over."""
    variant: str
    bm: int
    bn: int
    bk: int
    split: int

    def blocks(self, n_out: int, cout: int) -> int:
        return -(-n_out // self.bm) * -(-cout // self.bn) * self.split


def tc_smem_bytes(bn: int, bk: int, k_vol: int) -> int:
    """Shared memory of one tensor-core block (``TcTile::smem_bytes`` in
    ``csrc/sparse_conv.cu``): the ring of staged gathered rows and W slices
    (rows padded by 8 bf16) or, if larger, the f32 partial tile of a split;
    then the tile's ``[TC_BM, k_vol]`` map block and its live-offset list."""
    ring = TC_STAGES * (TC_BM * (bk + 8) + bk * (bn + 8)) * 2
    partial = TC_BM * (bn + 4) * 4
    return max(ring, partial) + (TC_BM * k_vol + k_vol + 1) * 4


def tcw_smem_bytes(bn: int, bk: int) -> int:
    """Shared memory of one wide-K tensor-core block (``TcwTile::SMEM_BYTES``
    in ``csrc/sparse_conv.cu``): the ring or the split's partial tile, then
    one ``[TC_BM, WK_CHUNK]`` map chunk (rows padded by one int), its live
    flags and list, and three counters; the same at any ``k_vol``."""
    ring = TC_STAGES * (TC_BM * (bk + 8) + bk * (bn + 8)) * 2
    partial = TC_BM * (bn + 4) * 4
    return max(ring, partial) + (TC_BM * (WK_CHUNK + 1) + 2 * WK_CHUNK + 4) * 4


def cin1_smem_bytes(bm: int, k_vol: int) -> int:
    """Shared memory of one cin = 1 block (``cin1_smem_bytes`` in
    ``csrc/sparse_conv.cu``): the block's ``[bm, k_vol]`` map block, one
    pass's ``W[:, 0, :32]`` as f32, and the pass's output tile (rows padded
    by one f32)."""
    return (bm * k_vol + k_vol * CIN1_BN + bm * (CIN1_BN + 1)) * 4


def conv_plan(n_out: int, cin: int, cout: int, k_vol: int, dtype: torch.dtype,
              aligned: bool = True) -> ConvPlan:
    """The variant, tile and split for a call, from capacities only (the
    host knows no live counts and does not sync for them).

    Tensor cores take bf16 with ``cin % 8 == 0``, ``cout % 8 == 0`` and
    16-byte aligned operands. Their tile is ``TC_BM`` rows by 32, 64 or 128
    channels (the least that holds ``cout``, else 128); a 128-wide tile
    steps 64 input channels where a row's product per offset is wide
    (``cin · cout ≥ WIDE_MACS``), every other tile 32. The live offsets
    are split over the fewest blocks (a power of two, at most ``MAX_SPLIT``
    and ``k_vol``) that give ``TARGET_BLOCKS`` blocks and at most
    ``MAX_STEPS`` steps a block: dead tiles exit early, so the coarse
    levels need the split to keep the SMs busy, and a block's steps run one
    after another. Where the block's shared memory (``tc_smem_bytes``,
    growing with ``k_vol``) passes ``SMEM_LIMIT``, the step and then the
    tile narrow until it fits; a ``k_vol`` that fits no tile (over 351)
    takes the wide-K variant at the tile it started from, whose map block
    is staged in chunks. Its split only fills ``TARGET_BLOCKS``, since a
    tile walks its live offsets alone, a few of ``k_vol``, and every part
    reads the whole map block.

    One input channel (bf16 or f32, any alignment) takes the cin = 1
    variant with the most rows a block (``CIN1_BMS``) whose shared memory
    (``cin1_smem_bytes``) fits, else the scalar one."""
    if cin == 1 and dtype in _DTYPES:
        for bm in CIN1_BMS:
            if cin1_smem_bytes(bm, k_vol) <= SMEM_LIMIT:
                return ConvPlan("cin1", bm, CIN1_BN, 1, 1)
        return ConvPlan("scalar", *SCALAR_TILE, 1)
    if dtype != torch.bfloat16 or cin % 8 or cout % 8 or not aligned:
        return ConvPlan("scalar", *SCALAR_TILE, 1)
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    bk = 64 if bn == 128 and cin * cout >= WIDE_MACS else 32
    wide = (bn, bk)
    while tc_smem_bytes(bn, bk, k_vol) > SMEM_LIMIT:
        if bk > 32:
            bk = 32
        elif bn > 32:
            bn //= 2
        else:
            return _wide_plan(n_out, cout, *wide)
    tiles = -(-n_out // TC_BM) * -(-cout // bn)
    steps = k_vol * -(-cin // bk)
    split = 1
    while ((tiles * split < TARGET_BLOCKS or steps > MAX_STEPS * split)
           and 2 * split <= min(MAX_SPLIT, k_vol)):
        split *= 2
    return ConvPlan("tc", TC_BM, bn, bk, split)


def _wide_plan(n_out: int, cout: int, bn: int, bk: int) -> ConvPlan:
    tiles = -(-n_out // TC_BM) * -(-cout // bn)
    split = 1
    while tiles * split < TARGET_BLOCKS and 2 * split <= MAX_SPLIT:
        split *= 2
    return ConvPlan("tcw", TC_BM, bn, bk, split)


def _check_plan(plan: ConvPlan, x: torch.Tensor, nbr: torch.Tensor,
                w: torch.Tensor) -> None:
    if plan.variant == "scalar":
        return
    cin, cout = w.shape[1], w.shape[2]
    if plan.variant == "cin1":
        if (cin != 1 or plan.bm not in CIN1_BMS or (plan.bn, plan.bk, plan.split)
                != (CIN1_BN, 1, 1) or cin1_smem_bytes(plan.bm, nbr.shape[1]) > SMEM_LIMIT):
            raise ValueError(f"gather_gemm: {plan} does not fit x {tuple(x.shape)}, "
                             f"nbr {tuple(nbr.shape)}, w {tuple(w.shape)}")
        return
    smem = (tcw_smem_bytes(plan.bn, plan.bk) if plan.variant == "tcw"
            else tc_smem_bytes(plan.bn, plan.bk, nbr.shape[1]))
    if (plan.variant not in ("tc", "tcw") or (plan.bm, plan.bn, plan.bk) not in TC_TILES
            or plan.split not in (1, 2, 4, 8) or plan.bm % plan.split
            or x.dtype != torch.bfloat16 or cin % 8 or cout % 8
            or not _aligned(x, w) or smem > SMEM_LIMIT):
        raise ValueError(f"gather_gemm: {plan} does not fit bf16 x "
                         f"{tuple(x.shape)}, nbr {tuple(nbr.shape)}, "
                         f"w {tuple(w.shape)}")


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {x.device}; kernel A "
                         f"runs on CUDA tensors")


def _aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


def gather_gemm_plain(x: torch.Tensor, nbr: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Plain version: append a zero row to ``x``, gather [N, K, Cin], one
    product with f32 accumulation (``imfnet_tpu.sparse.ops._flat_apply``).
    bf16 operands are widened to f32 before the product, so each product is
    exact and only the f32 sums round. f64 operands (CPU only, for gradient
    checks) give an f64 result."""
    n_in, cin = x.shape
    n_out, k = nbr.shape
    cout = w.shape[2]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    x_ext = torch.cat([x, x.new_zeros((1, cin))], dim=0)
    idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, n_in)).long()
    g = x_ext[idx].reshape(n_out, k * cin)
    return g.to(acc) @ w.reshape(k * cin, cout).to(acc)


def _check(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 3 or nbr.dim() != 2:
        raise ValueError(f"gather_gemm: want x[N,Cin], nbr[N_out,K], "
                         f"w[K,Cin,Cout]; got {tuple(x.shape)}, "
                         f"{tuple(nbr.shape)}, {tuple(w.shape)}")
    if w.shape[0] != nbr.shape[1] or w.shape[1] != x.shape[1]:
        raise ValueError(f"gather_gemm: shapes disagree: x {tuple(x.shape)}, "
                         f"nbr {tuple(nbr.shape)}, w {tuple(w.shape)}")
    dtypes = _DTYPES + ((torch.float64,) if x.device.type == "cpu" else ())
    if x.dtype not in dtypes or w.dtype != x.dtype:
        raise TypeError(f"gather_gemm: x and w must share a dtype in "
                        f"{dtypes}; got {x.dtype}, {w.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"gather_gemm: nbr must be int32, got {nbr.dtype}")
    if not (x.device == nbr.device == w.device):
        raise ValueError("gather_gemm: x, nbr and w must share a device")
    if not (x.is_contiguous() and nbr.is_contiguous() and w.is_contiguous()):
        raise ValueError("gather_gemm: x, nbr and w must be contiguous")


def gather_gemm(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32[n_out, cout]. CUDA tensors launch kernel A in the variant that
    ``conv_plan`` chooses for the call (``run_plan``); CPU tensors run the
    plain version (which also takes f64, for gradient checks)."""
    _check(x, nbr, w)
    if x.device.type == "cpu":
        return gather_gemm_plain(x, nbr, w)
    _check_cuda(x)
    n_out, k = nbr.shape
    plan = conv_plan(n_out, w.shape[1], w.shape[2], k, x.dtype, _aligned(x, w))
    return run_plan(x, nbr, w, plan)


def run_plan(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
             plan: ConvPlan, tally: bool = True) -> torch.Tensor:
    """Kernel A on CUDA tensors in the given plan, counted in
    ``gather_gemm.launches`` and the variant's ``launches_<variant>``. A
    plan that does not fit the call raises. The port calls it through
    ``gather_gemm``; ``conv_sweep.py``, ``chip_smoke.py`` and the card tests
    call it with plans of their own. ``tally=False`` launches the wide-K
    variant without its walk tally (to time what the tally costs)."""
    _check(x, nbr, w)
    _check_cuda(x)
    n_out, k = nbr.shape
    cin, cout = w.shape[1], w.shape[2]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=x.device)
    if n_out == 0 or cout == 0:
        return out
    _check_plan(plan, x, nbr, w)
    lib = _library()
    words = (torch.zeros((2,), dtype=torch.int64, device=x.device)
             if plan.variant == "tcw" and tally else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sparse_conv_gather_gemm(
            x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
            n_out, k, cin, cout, int(x.dtype == torch.bfloat16),
            _VARIANTS[plan.variant], plan.bm, plan.bn, plan.bk, plan.split,
            None if words is None else words.data_ptr(), stream)
        cuda_build.check(rc, "sparse_conv_gather_gemm")
        if words is not None:
            timer.count_device({"conv.slots_walked": words[0:1],
                                "conv.entries_live": words[1:2],
                                "conv.map_slots": n_out * k})
    launches.count(gather_gemm)
    launches.count(gather_gemm, f"launches_{plan.variant}")
    return out


gather_gemm.launches = 0
gather_gemm.launches_tc = 0
gather_gemm.launches_cin1 = 0
gather_gemm.launches_tcw = 0
gather_gemm.launches_scalar = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("sparse_conv")
    fn = lib.sparse_conv_gather_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2
    return lib
