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
- ``"tcw"``: the wide-K walk, where a tile's ``[128, k_vol]`` map block
  would not fit a block's shared memory (the 6-D k3 convs of ``eval.dgr``,
  k_vol 729, whose maps hold a few live entries a row). Weight-stationary:
  one pass over the dense map lists the live entries on the card by
  (rank, offset), a row's rank-r entry being its r-th live offset
  (``tcw_lists``); then persistent blocks claim chunks of ``bm`` entries
  of one list in (pass, rank, offset) order, a pass ``split`` offsets
  whose W slices stay in L2, stage ``W[k]`` once a chunk and multiply on
  the tensor cores. Round r (every row's rank-r entry) has one entry a
  row; a row's commit waits, by a flag a row, until its earlier entries
  are in, so each row adds its products in ascending offset order with no
  float atomic (``gather_gemm_tcw_plain`` gives the same sums in plain
  PyTorch). Each launch tallies on the card the row slots
  its products cover (each list rounded up to 16-row groups), the live
  entries, and the entries whose commit had to wait for its row's earlier
  entry (``conv.slots_walked``, ``conv.entries_live``,
  ``conv.entries_waited``, beside the map's ``conv.map_slots``, N_out ×
  k_vol; ``utils.timer.count_device``).
- ``"cin1"``: one input channel, bf16 or f32, at any alignment (conv1 of
  every training step and of SimpleNet, k 125): one thread per output row
  with 32 f32 accumulators (a wider ``cout`` in passes of 32), the block's
  ``[bm, k_vol]`` map block and the pass's ``W[:, 0, :]`` staged in shared
  memory, one gathered scalar per offset, summed in offset order.
- ``"scalar"``: everything else (f32 operands at ``cin > 1``, other widths,
  and a cin = 1 ``k_vol`` whose map block would not fit a block's shared
  memory): f32 FMAs on a 64 × 64 tile.

``gather_gemm`` is the port's entry point; ``run_plan`` launches a given
plan, for ``conv_sweep.py`` and the card tests; ``tcw_lists`` runs the wide-K
walk's list build alone, for the card tests and its timing. Inside
``shared_lists()`` consecutive wide-K calls on the same map share one list
build (a residual block's two convs).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator, List, NamedTuple, Tuple

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
TCW_BM = 64               # entries a chunk of the wide-K walk (its product's rows)
TCW_BK = 32               # its input channels a step
TCW_GROUP = 16            # rows of its mma tiles: groups past a chunk's entries are skipped
TCW_BNS = (32, 64, 128, 256)   # its output-channel tiles (csrc TCW_INSTANCES)
TCW_L2_BYTES = 24 << 20   # W slices its pass of offsets keeps in the 50 MB L2
TCW_RANK_SHIFT = 22       # a list entry: output row | rank << 22
TCW_MAX_ROWS = 1 << TCW_RANK_SHIFT
TCW_MAX_K = 1 << (32 - TCW_RANK_SHIFT)
TCW_MAX_SLOTS = (1 << 31) - 1   # map slots n_out · k_vol: its lists count entries in int32
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


def tcw_smem_bytes(bn: int) -> int:
    """Shared memory of one block of the wide-K walk (``TwTile::SMEM_BYTES``
    in ``csrc/sparse_conv.cu``): the ring of staged gathered rows and W
    slices (rows padded by 8 bf16), the chunk's rows, ranks and sources,
    and the claimed chunk; the same at any ``k_vol``."""
    ring = TC_STAGES * (TCW_BM * (TCW_BK + 8) + TCW_BK * (bn + 8)) * 2
    return ring + (3 * TCW_BM + 4) * 4


def _tcw_layout(n_out: int, k_vol: int, ob: int) -> List[int]:
    """The parts of a wide-K call's int32 scratch, in order
    (``TcwScratch`` in ``csrc/sparse_conv.cu``): the (pass, rank) items'
    words (two ints each), eight words, the pairs' counts (a pair is (pass,
    rank, offset in the pass)), the offsets' counts, the pairs' first
    entries, the offsets' first entries, three ints a chunk (at most
    n_out · k_vol / TCW_BM + the pairs), a commit flag a row, and the live
    entries listed by offset and by pair, one int a map slot each."""
    passes = -(-k_vol // ob)
    pairs = passes * k_vol * ob
    chunks = n_out * k_vol // TCW_BM + pairs
    return [2 * passes * k_vol, 8, pairs, k_vol, pairs, k_vol + 1, 3 * chunks, n_out,
            k_vol * n_out, k_vol * n_out]


def tcw_scratch_ints(n_out: int, k_vol: int, ob: int) -> int:
    """int32 scratch of one wide-K call in passes of ``ob`` offsets: 782 MB
    at 131 072 × 729, nearly all of it the two lists."""
    return sum(_tcw_layout(n_out, k_vol, ob))


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
    takes the wide-K walk: chunks of ``TCW_BM`` entries, ``TCW_BK`` input
    channels a step, the least output-channel tile of ``TCW_BNS`` that
    holds ``cout`` (else the widest, in turns), and in the place of the
    split (its blocks are persistent) the offsets of a pass: all of them
    where ``W`` fits ``TCW_L2_BYTES``, else equal passes that each do.

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
    while tc_smem_bytes(bn, bk, k_vol) > SMEM_LIMIT:
        if bk > 32:
            bk = 32
        elif bn > 32:
            bn //= 2
        else:
            return _wide_plan(cin, cout, k_vol)
    tiles = -(-n_out // TC_BM) * -(-cout // bn)
    steps = k_vol * -(-cin // bk)
    split = 1
    while ((tiles * split < TARGET_BLOCKS or steps > MAX_STEPS * split)
           and 2 * split <= min(MAX_SPLIT, k_vol)):
        split *= 2
    return ConvPlan("tc", TC_BM, bn, bk, split)


def _wide_plan(cin: int, cout: int, k_vol: int) -> ConvPlan:
    bn = next((b for b in TCW_BNS if cout <= b), TCW_BNS[-1])
    passes = -(-k_vol * cin * cout * 2 // TCW_L2_BYTES)
    return ConvPlan("tcw", TCW_BM, bn, TCW_BK, -(-k_vol // passes))


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
    n_out, k_vol = nbr.shape
    if plan.variant == "tcw":
        fits = ((plan.bm, plan.bk) == (TCW_BM, TCW_BK) and plan.bn in TCW_BNS
                and 1 <= plan.split <= k_vol
                and tcw_smem_bytes(plan.bn) <= SMEM_LIMIT
                and _tcw_fits(n_out, k_vol))
    else:
        fits = (plan.variant == "tc" and (plan.bm, plan.bn, plan.bk) in TC_TILES
                and plan.split in (1, 2, 4, 8) and not plan.bm % plan.split
                and tc_smem_bytes(plan.bn, plan.bk, k_vol) <= SMEM_LIMIT)
    if (not fits or x.dtype != torch.bfloat16 or cin % 8 or cout % 8
            or not _aligned(x, w)):
        raise ValueError(f"gather_gemm: {plan} does not fit bf16 x "
                         f"{tuple(x.shape)}, nbr {tuple(nbr.shape)}, "
                         f"w {tuple(w.shape)}")


def _tcw_fits(n_out: int, k_vol: int) -> bool:
    return 0 < n_out <= TCW_MAX_ROWS and 0 < k_vol <= TCW_MAX_K and n_out * k_vol <= TCW_MAX_SLOTS


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


def tcw_lists_plain(nbr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the wide-K walk lists, in plain PyTorch: int64[k_vol] each
    offset's live entries, and int64[n_out, k_vol] each live entry's rank
    in its row (its live entries in offset order: 0, 1, ...; -1 where
    dead). Offset k's list holds the rows ``nbr[:, k] >= 0``; the card
    writes them in an order of its own."""
    live = nbr >= 0
    rank = torch.where(live, live.long().cumsum(1) - 1, torch.full_like(nbr, -1).long())
    return live.sum(0), rank


def tcw_tally_plain(nbr: torch.Tensor) -> Dict[str, int]:
    """The wide-K walk's tally of one call, from the map alone: the row
    slots its products cover (each (rank, offset) list rounded up to
    ``TCW_GROUP`` rows, whatever its passes), the live entries and the
    map's slots. Its fourth, ``conv.entries_waited``, depends on timing and
    has no plain count."""
    k_vol = nbr.shape[1]
    _, rank = tcw_lists_plain(nbr)
    live = rank >= 0
    pair = rank[live] * k_vol + torch.nonzero(live)[:, 1]
    counts = torch.bincount(pair)
    return {"conv.slots_walked": int((-(-counts // TCW_GROUP) * TCW_GROUP).sum()),
            "conv.entries_live": int(live.sum()),
            "conv.map_slots": nbr.shape[0] * k_vol}


def gather_gemm_tcw_plain(x: torch.Tensor, nbr: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """The wide-K walk's sums in plain PyTorch (tests only): the product of
    each live entry's input row by ``W[k]`` (operands widened, so each
    product is exact and its sum over channels rounds in f32), added to its
    row in ascending offset order, as the card's rounds add them: the
    product itself at the row's rank-0 entry, else the row's sum so far
    plus it. Taken offset by offset here, which gives every row the same
    sequence of additions. Rows with no live entry are 0."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    _, rank = tcw_lists_plain(nbr)
    out = torch.zeros((nbr.shape[0], w.shape[2]), dtype=acc)
    for k in range(nbr.shape[1]):
        rows = torch.nonzero(nbr[:, k] >= 0).squeeze(1)
        if rows.numel() == 0:
            continue
        p = x[nbr[rows, k].long()].to(acc) @ w[k].to(acc)
        first = (rank[rows, k] == 0)[:, None]
        out[rows] = torch.where(first, p, out[rows] + p)
    return out


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
    walk without its tally (to time what the tally costs). The wide-K walk
    takes ``tcw_scratch_ints`` int32 of scratch for the call (its lists),
    allocated here, so its size is fixed by the shapes."""
    _check(x, nbr, w)
    _check_cuda(x)
    n_out, k = nbr.shape
    cin, cout = w.shape[1], w.shape[2]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=x.device)
    if n_out == 0 or cout == 0:
        return out
    _check_plan(plan, x, nbr, w)
    lib = _library()
    wide = plan.variant == "tcw"
    words = torch.empty((3,), dtype=torch.int64, device=x.device) if wide and tally else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        kept = _kept_lists(nbr, plan, stream) if wide else None
        if kept is not None:
            rc = lib.sparse_conv_tcw_again(
                x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(), n_out, k, cin,
                cout, plan.bn, plan.split, kept.data_ptr(),
                None if words is None else words.data_ptr(), stream)
        else:
            scratch = (torch.empty((tcw_scratch_ints(n_out, k, plan.split),),
                                   dtype=torch.int32, device=x.device) if wide else None)
            rc = lib.sparse_conv_gather_gemm(
                x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
                n_out, k, cin, cout, int(x.dtype == torch.bfloat16),
                _VARIANTS[plan.variant], plan.bm, plan.bn, plan.bk, plan.split,
                None if scratch is None else scratch.data_ptr(),
                None if words is None else words.data_ptr(), stream)
            if wide:
                _keep_lists(nbr, plan, stream, scratch)
        cuda_build.check(rc, "sparse_conv_gather_gemm")
        if words is not None:
            timer.count_device({"conv.slots_walked": words[0:1],
                                "conv.entries_live": words[1:2],
                                "conv.entries_waited": words[2:3],
                                "conv.map_slots": n_out * k})
    launches.count(gather_gemm)
    launches.count(gather_gemm, f"launches_{plan.variant}")
    return out


gather_gemm.launches = 0
gather_gemm.launches_tc = 0
gather_gemm.launches_cin1 = 0
gather_gemm.launches_tcw = 0
gather_gemm.launches_scalar = 0

_scope = threading.local()   # the open shared_lists scope: the last wide-K build


@contextlib.contextmanager
def shared_lists() -> Iterator[None]:
    """Inside it, a wide-K call on the same map tensor as the last wide-K
    call of the scope (the same version, pass size and stream) walks the
    lists that call built, with no list build of its own: only the rows'
    flags and the dead rows' zeros are reset. The scope holds the last
    build's scratch until it closes. Per thread; scopes nest."""
    outer = getattr(_scope, "last", None)
    _scope.last = {}
    try:
        yield
    finally:
        _scope.last = outer


def _kept_lists(nbr: torch.Tensor, plan: ConvPlan, stream: int):
    last = getattr(_scope, "last", None)
    if not last or last["nbr"] is not nbr:
        return None
    same = (last["version"], last["ob"], last["stream"]) == (nbr._version, plan.split, stream)
    return last["scratch"] if same else None


def _keep_lists(nbr: torch.Tensor, plan: ConvPlan, stream: int, scratch: torch.Tensor) -> None:
    if getattr(_scope, "last", None) is not None:
        _scope.last = {"nbr": nbr, "version": nbr._version, "ob": plan.split,
                       "stream": stream, "scratch": scratch}


def tcw_lists(nbr: torch.Tensor, cout: int = 8, ob: int = 0) -> Dict[str, torch.Tensor]:
    """The wide-K walk's list build alone, on the card, as ``run_plan``
    runs it in passes of ``ob`` offsets (all by default; no launch
    counted). A pair (pass, rank, offset in the pass) is p = (pass · k_vol
    + rank) · ob + offset % ob, listed in that order: ``top_rank`` (the
    highest rank, a 1-element tensor), ``first`` int32 (pair p's first
    entry in ``lists``, for the ranks up to ``top_rank``), ``lists``
    int32[n_out · k_vol] (``row | rank << TCW_RANK_SHIFT``, a pair's in an
    order of the card's), ``chunks`` (their number, a 1-element tensor),
    ``offset_counts`` int32[k_vol], ``flags`` int32[n_out] (each row's
    commit flag, reset to 0), ``out`` f32[n_out, cout] (0 at rows with no
    live entry, not written elsewhere), and the totals the walk's tally
    takes: ``entries`` (live) and ``slots`` (1-element tensors)."""
    if nbr.dim() != 2 or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError("tcw_lists: nbr must be a contiguous int32[N_out, K]")
    _check_cuda(nbr)
    n_out, k = nbr.shape
    ob = ob or k
    if not _tcw_fits(n_out, k) or cout % 8 or not 1 <= ob <= k:
        raise ValueError(f"tcw_lists: no list build for nbr {tuple(nbr.shape)}, cout {cout}")
    scratch = torch.empty((tcw_scratch_ints(n_out, k, ob),), dtype=torch.int32,
                          device=nbr.device)
    out = torch.empty((n_out, cout), dtype=torch.float32, device=nbr.device)
    with torch.cuda.device(nbr.device):
        rc = _library().sparse_conv_tcw_lists(
            nbr.data_ptr(), out.data_ptr(), n_out, k, cout, ob, scratch.data_ptr(), None,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check(rc, "sparse_conv_tcw_lists")
    _, misc, _, counts, first, _, _, flags, _, lists = torch.split(
        scratch, _tcw_layout(n_out, k, ob))
    return {"offset_counts": counts, "top_rank": misc[1:2], "chunks": misc[2:3],
            "entries": misc[4:5], "slots": misc[5:6], "first": first, "flags": flags,
            "lists": lists, "out": out}


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("sparse_conv")
    fn = lib.sparse_conv_gather_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
    fn = lib.sparse_conv_tcw_lists
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn = lib.sparse_conv_tcw_again
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    fn = lib.sparse_conv_tcw_scratch_ints
    fn.restype = ctypes.c_ulonglong
    fn.argtypes = [ctypes.c_int] * 3
    return lib
