"""Grid-extent voxel quantization and the grid kernel-map builder
(``imfnet_tpu.sparse.grid``).

``quantize_grid`` voxelizes raw points inside a static per-batch extent;
its compaction tail runs in plain PyTorch (``compact_impl="auto"``) or
through kernel C (``"kernel"``, ``sparse.quant_kernel``).

``build_pyramid_grid`` builds the coordinate pyramid from each level's
occupancy, held as 32-bit z-bitmask words over the halo'd extent,

    word w = (b, cx, cy, cz >> 5)    bits[w] bit (cz & 31) = occupied
    rank[w] = occupied cells in the words before w (scan order)

Level tables are in scan order, so the row of an occupied cell is
``rank[w] + popcount(bits[w] & below_bit)``, and one 2-word window (a word
and its successor in the same (x, y) column) answers every z-offset of a
kernel column. Only occupied words are stored: ``compact_words`` sorts
them into a table of word keys with their windows, and kernel D
(``sparse.word_map_kernel.word_match_many``) finds the window of every
query's anchor word, all of a pyramid's maps in one launch. The level
tables are the search builder's (``sparse.kernel_map.build_pyramid``),
and so are the maps for in-extent inputs, which is all ``quantize_grid``
produces.

32-bit occupancy words are held in int64 (torch's uint32 lacks most bitwise
ops) and stored in int32 tables as their two's-complement bit pattern, as
the JAX package's ``astype(int32)`` does; torch has no popcount, so
``popcount32`` is a SWAR count.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from imfnet_tpu_torch.sparse.coords import (PAD_COORD, SparseVoxels, compact_first, row_mask,
                                          voxel_cells)
from imfnet_tpu_torch.sparse.kernel_map import CoordinatePyramid, LevelMaps
from imfnet_tpu_torch.sparse.quant_kernel import (INVALID_KEY, sorted_compact,
                                                  sorted_compact_plain)
from imfnet_tpu_torch.sparse.word_map_kernel import word_match_many

HALO = 2          # cells of slack on every axis: offset queries never bounds-check
WORD_PAD = 0x7FFFFFFF   # word key of compact-table padding (sorts last)
WORD_MASK = 0xFFFFFFFF
COMPACT_IMPLS = ("auto", "kernel")


class GridSpec(NamedTuple):
    """Static grid extents in stride-1 voxel cells."""

    extent: Tuple[int, int, int] = (256, 256, 256)
    num_batches: int = 2

    def level_dims(self, level: int) -> Tuple[int, int, int]:
        return tuple(-(-e // (1 << level)) for e in self.extent)


def batch_origins(coords: torch.Tensor, valid: torch.Tensor,
                  num_batches: int) -> torch.Tensor:
    """Per-batch minimum voxel coordinate, int32[num_batches, 3] (``1 << 20``
    for a batch with no valid row)."""
    big = 1 << 20
    mins = []
    for b in range(num_batches):
        sel = ((coords[:, 0] == b) & valid)[:, None]
        vals = torch.where(sel, coords[:, 1:], torch.full_like(coords[:, 1:], big))
        mins.append(vals.min(dim=0).values)
    return torch.stack(mins)


def origin_lookup(origins: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``origins[b]`` for in-range ``b``; any other batch index resolves to
    ``origins[0]`` (such rows are masked downstream)."""
    out = origins[0].expand(*b.shape, origins.shape[1])
    for i in range(1, origins.shape[0]):
        out = torch.where((b == i)[..., None], origins[i], out)
    return out


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & WORD_MASK) >> 24


def _as_int32(word: torch.Tensor) -> torch.Tensor:
    """int64 word in [0, 2^32) → int32 with the same bit pattern."""
    return (word - ((word >> 31) << 32)).to(torch.int32)


def _packed_dims(spec: GridSpec, level: int) -> Tuple[int, int, int, int]:
    e = spec.level_dims(level)
    x, y, zc = e[0] + 2 * HALO, e[1] + 2 * HALO, e[2] + 2 * HALO
    return x, y, zc, -(-zc // 32)


def _rel_cells(coords: torch.Tensor, origins: torch.Tensor, level: int,
               num_batches: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, rel_cell[N,3]) of each row at ``level`` in the halo'd grid."""
    b = coords[:, 0].clamp(0, num_batches - 1)
    o = origin_lookup(origins, b) >> level
    return b, (coords[:, 1:] >> level) - o + HALO


def _in_dims(valid: torch.Tensor, c: torch.Tensor, x_d: int, y_d: int,
             zc_d: int) -> torch.Tensor:
    return (valid & (c >= 0).all(dim=1)
            & (c[:, 0] < x_d) & (c[:, 1] < y_d) & (c[:, 2] < zc_d))


def _word_index(b, cx, cy, zw, dims) -> torch.Tensor:
    """int64 word index of (b, cx, cy, z-word); int64 so that masked garbage
    rows cannot overflow."""
    x_d, y_d, _, zw_d = dims
    return ((b.long() * x_d + cx) * y_d + cy) * zw_d + zw


def fits_grid(coords_np: np.ndarray, valid_count: int, spec: GridSpec) -> bool:
    """Host-side check whether a batch fits the static extents."""
    c = coords_np[:valid_count]
    if len(c) == 0:
        return True
    span = c[:, 1:].max(0) - c[:, 1:].min(0) + 1
    return bool((span <= np.array(spec.extent)).all())


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def cell_keys(xyz: torch.Tensor, valid: torch.Tensor, voxel_size: float,
              spec: GridSpec, batch_index: torch.Tensor | int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coords4 int32[n,4], key int64[n]): each raw point's voxel and its
    cell key ``((b·X + x)·Y + y)·Z + z`` relative to its batch's origin,
    ``INVALID_KEY`` for points that are invalid or outside the extent."""
    X, Y, Z = spec.extent
    B = spec.num_batches
    n = xyz.shape[0]
    v = voxel_cells(xyz, voxel_size)
    if isinstance(batch_index, int):
        b = torch.full((n,), batch_index, dtype=torch.int32, device=xyz.device)
    else:
        b = batch_index.to(torch.int32)
    coords4 = torch.cat([b[:, None], v], dim=1)
    origins = batch_origins(coords4, valid, B)

    bb = coords4[:, 0].clamp(0, B - 1).to(torch.int64)
    c = coords4[:, 1:].to(torch.int64) - origins.to(torch.int64)[bb]
    in_range = (
        valid
        & (coords4[:, 0] >= 0) & (coords4[:, 0] < B)
        & (c >= 0).all(dim=1)
        & (c[:, 0] < X) & (c[:, 1] < Y) & (c[:, 2] < Z)
    )
    key = ((bb * X + c[:, 0]) * Y + c[:, 1]) * Z + c[:, 2]
    return coords4, torch.where(in_range, key, torch.full_like(key, INVALID_KEY))


def quantize_grid(
    xyz: torch.Tensor,
    feats: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    n_out: int,
    spec: GridSpec,
    batch_index: torch.Tensor | int = 0,
    compact_impl: str = "auto",
):
    """Voxelize raw points: ``floor(xyz / voxel)`` per batch, first occurrence
    (minimum original row) wins, rows out in scan order (lexicographic
    (batch, x, y, z)). Points outside the per-batch extent are dropped; on
    overflow the first ``n_out`` voxels in scan order are kept.

    A stable sort on the cell key makes the first row of each equal-key run
    the minimum original row; run starts mark unique cells and are compacted
    in sorted order, which is scan order. ``compact_impl="auto"`` compacts in
    plain PyTorch, ``"kernel"`` through kernel C (its plain version on the
    CPU); both give the same output.

    Returns (SparseVoxels, sel int64[n_out] (-1 in padding), xyz_down[n_out,3]).
    """
    if compact_impl not in COMPACT_IMPLS:
        raise ValueError(f"quantize_grid: compact_impl must be one of "
                         f"{COMPACT_IMPLS}, got {compact_impl!r}")
    coords4, key = cell_keys(xyz, valid, voxel_size, spec, batch_index)
    sk, order = torch.sort(key, stable=True)
    compact = sorted_compact if compact_impl == "kernel" else sorted_compact_plain
    sel, n_uniq = compact(sk, order, n_out)
    ok = sel >= 0
    ss = sel.clamp_min(0)
    uniq = torch.where(ok[:, None], coords4[ss],
                       torch.full_like(coords4[:1], PAD_COORD))
    f = torch.where(ok[:, None], feats[ss], torch.zeros_like(feats[:1]))
    xyz_down = torch.where(ok[:, None], xyz[ss], torch.zeros_like(xyz[:1]))
    return SparseVoxels(uniq, f, n_uniq), sel, xyz_down


# ---------------------------------------------------------------------------
# Kernel maps from compact occupied-word tables (kernel D)
# ---------------------------------------------------------------------------

class _Columns(NamedTuple):
    """Word-window queries of all (dx, dy) kernel columns, in product order."""

    w0: torch.Tensor                 # int64[N, ncol] anchor word (garbage unless ok_xy)
    zlo_w: torch.Tensor              # int32[N, 1] anchor z-word
    ok_xy: torch.Tensor              # bool[N, ncol] column structurally valid
    zrels: torch.Tensor              # int32[N, 1, kz] z-cell of every z-offset
    aligned: Optional[torch.Tensor]  # bool[N, ncol, kz] lattice parity ('up' only)


def _offset_columns(origins: torch.Tensor, coords: torch.Tensor,
                    valid: torch.Tensor, spec: GridSpec, *, table_level: int,
                    kernel_size: int, mode: str) -> _Columns:
    """The (dx, dy) columns of a kernel map, all at once.

    mode='same': queries on the table's own lattice, offsets of ±r cells.
    mode='down': queries at a coarser level gather from this finer table;
        offsets are ±r cells of the finer lattice.
    mode='up': queries at a finer level gather from this coarser table;
        parity of the fine-lattice target decides both the coarse cell
        (floor((m+δ)/2)) and whether it exists (alignment).
    The JAX package loops over the columns; every tensor here has one more
    axis instead, so a map costs a fixed number of ops whatever its width.
    """
    dims = _packed_dims(spec, table_level)
    x_d, y_d, zc_d, _ = dims
    r = kernel_size // 2
    dev = coords.device
    d = torch.arange(-r, r + 1, dtype=torch.int32, device=dev)
    dx = d.repeat_interleave(2 * r + 1)[None, :]   # [1, ncol], dx slowest
    dy = d.repeat(2 * r + 1)[None, :]
    dz = d[None, None, :]                          # [1, 1, kz]
    if mode == "up":
        b = coords[:, 0].clamp(0, spec.num_batches - 1)
        m = coords[:, 1:] >> (table_level - 1)
        o_cell = origin_lookup(origins, b) >> table_level
        mx, my = m[:, 0:1] + dx, m[:, 1:2] + dy
        cx = (mx >> 1) - o_cell[:, 0:1] + HALO
        cy = (my >> 1) - o_cell[:, 1:2] + HALO
        zlo = ((m[:, 2:3] - r) >> 1) - o_cell[:, 2:3] + HALO
        ok_xy = (valid[:, None] & (cx >= 0) & (cx < x_d) & (cy >= 0) & (cy < y_d)
                 & (zlo >= 0) & (zlo < zc_d - 1))
        zq = m[:, 2:3, None] + dz
        zrels = (zq >> 1) - o_cell[:, 2:3, None] + HALO
        aligned = ((((mx & 1) == 0) & ((my & 1) == 0))[:, :, None]
                   & ((zq & 1) == 0))
    elif mode in ("same", "down"):
        b, base = _rel_cells(coords, origins, table_level, spec.num_batches)
        base_ok = (valid & (base >= r).all(dim=1)
                   & (base[:, 0] < x_d - r) & (base[:, 1] < y_d - r)
                   & (base[:, 2] < zc_d - r))
        cx, cy = base[:, 0:1] + dx, base[:, 1:2] + dy
        ok_xy = base_ok[:, None].expand(cx.shape)
        zlo = base[:, 2:3] - r
        zrels = base[:, 2:3, None] + dz
        aligned = None
    else:
        raise ValueError(f"mode must be 'same', 'down' or 'up', got {mode!r}")
    zlo_w = zlo >> 5
    return _Columns(_word_index(b[:, None], cx, cy, zlo_w, dims), zlo_w, ok_xy,
                    zrels, aligned)


def _column_rows(cols: _Columns, t4: torch.Tensor) -> torch.Tensor:
    """nbr int32[N, ncol·kz] from the columns' 2-word windows ``t4``
    int32[N, ncol, 4] (bits, bits1, rank, rank1) anchored at z-word
    ``cols.zlo_w``: a cell's row is its word's rank plus the set bits below
    it, -1 where absent."""
    sel = ((cols.zrels >> 5) - cols.zlo_w[..., None]) == 0
    bits = torch.where(sel, t4[..., 0:1], t4[..., 1:2]).long() & WORD_MASK
    rank = torch.where(sel, t4[..., 2:3], t4[..., 3:4])
    p = (cols.zrels & 31).long()
    below = bits & ((torch.ones_like(p) << p) - 1)
    row = rank + popcount32(below).to(torch.int32)
    ok = cols.ok_xy[:, :, None] & ((bits >> p) & 1).bool()
    if cols.aligned is not None:
        ok = ok & cols.aligned
    return torch.where(ok, row, -1).reshape(row.shape[0], -1)


class CompactWords(NamedTuple):
    """Sorted occupied z-words of one level table and their 2-word windows.

    wkeys:     int32[2·cap]    word keys, nondecreasing (pad ``WORD_PAD``),
               each key at most twice
    payload:   int32[2·cap, 4] (bits, bits1, rank, rank1) per entry
    n_words:   int32[]         entries in use
    sorted_ok: bool[]          keys nondecreasing (kernel D's precondition)
    """

    wkeys: torch.Tensor
    payload: torch.Tensor
    n_words: torch.Tensor
    sorted_ok: torch.Tensor


def compact_words(coords: torch.Tensor, valid: torch.Tensor, origins: torch.Tensor,
                  spec: GridSpec, level: int) -> CompactWords:
    """The compact sorted word table of one level table (scan order,
    unique), with no dense grid.

    Each occupied word v gets an anchor entry (its window) and a companion
    entry at key v-1 holding (0, bits[v], rank[v], rank[v]): an anchor word
    may itself be empty while its successor is occupied. Where v-1 is
    occupied, or v starts its z-column, the companion is a zero-payload
    duplicate of key v instead, so summing the entries of a key is exact."""
    dims = _packed_dims(spec, level)
    x_d, y_d, zc_d, zw_d = dims
    if spec.num_batches * x_d * y_d * zw_d >= WORD_PAD:
        raise ValueError(f"compact_words: the word grid of {spec} at level "
                         f"{level} overflows int32 word keys")
    n = coords.shape[0]
    dev = coords.device
    b, c = _rel_cells(coords, origins, level, spec.num_batches)
    in_r = _in_dims(valid, c, x_d, y_d, zc_d)
    wkey = torch.where(in_r, _word_index(b, c[:, 0], c[:, 1], c[:, 2] >> 5, dims),
                       WORD_PAD)
    # scan-ordered rows → word keys nondecreasing (verified, not trusted)
    sorted_ok = (wkey[1:] >= wkey[:-1]).all()
    first = (wkey != WORD_PAD) & torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev), wkey[1:] != wkey[:-1]])
    fi = first.long()
    cum = torch.cumsum(fi, 0)
    slot = torch.where(first, cum - fi, n)
    wkeys = torch.full((n + 1,), WORD_PAD, dtype=torch.int64, device=dev)
    wkeys = wkeys.scatter_(0, slot, wkey)[:n]
    # rank of a word = cells before it in scan order = its first row
    rank = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    rank = rank.scatter_(0, slot, torch.arange(n, device=dev))[:n]
    bslot = torch.where(in_r, (cum - 1).clamp(0, n - 1), n)
    bit = torch.ones_like(bslot) << (c[:, 2] & 31).long()
    bits = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    bits = bits.scatter_add_(0, bslot, bit)[:n] & WORD_MASK
    n_words = fi.sum()

    def shift_down(x, fill):
        return torch.cat([x[1:], x.new_full((1,), fill)])

    nxt = shift_down(wkeys, WORD_PAD)
    same_col = (nxt == wkeys + 1) & (torch.remainder(wkeys + 1, zw_d) != 0)
    bits1 = torch.where(same_col, shift_down(bits, 0), 0)
    rank1 = torch.where(same_col, shift_down(rank, 0), rank + popcount32(bits))

    valid_w = wkeys != WORD_PAD
    prev = torch.cat([wkeys.new_full((1,), WORD_PAD), wkeys[:-1]])
    need_comp = valid_w & (prev != wkeys - 1) & (torch.remainder(wkeys, zw_d) != 0)
    kb = torch.where(valid_w, torch.where(need_comp, wkeys - 1, wkeys), WORD_PAD)
    zero = torch.zeros_like(bits)
    comp = torch.where(need_comp[:, None],
                       torch.stack([zero, bits, rank, rank], dim=1), 0)
    anchor = torch.where(valid_w[:, None],
                         torch.stack([bits, bits1, rank, rank1], dim=1), 0)
    keys2 = torch.stack([kb, wkeys], dim=1).reshape(2 * n)
    payload2 = torch.stack([comp, anchor], dim=1).reshape(2 * n, 4)
    sorted_ok = sorted_ok & (keys2[1:] >= keys2[:-1]).all()
    payload2 = torch.cat([_as_int32(payload2[:, :2]), payload2[:, 2:].to(torch.int32)],
                         dim=1)
    return CompactWords(keys2.to(torch.int32), payload2.contiguous(),
                        (2 * n_words).to(torch.int32), sorted_ok)


def word_queries(origins: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                 spec: GridSpec, *, table_level: int, kernel_size: int,
                 mode: str) -> Tuple[torch.Tensor, _Columns]:
    """(q int32[N, kernel_size²], columns): the anchor word key of every
    query row and (dx, dy) column, -2 (matches nothing) where the column is
    not structurally valid."""
    cols = _offset_columns(origins, coords, valid, spec, table_level=table_level,
                           kernel_size=kernel_size, mode=mode)
    return torch.where(cols.ok_xy, cols.w0, -2).to(torch.int32), cols


def banded_word_t4_many(pairs: Sequence[Tuple[CompactWords, torch.Tensor]]
                        ) -> List[torch.Tensor]:
    """[t4 int32[N, ncol, 4]] for every (table, q): the (bits, bits1, rank,
    rank1) window of every anchor word key in ``q``, zeros where the word is
    absent. All pairs go to kernel D's grouped entry ``word_match_many``
    together (one launch for up to 16), which searches each table's
    ``n_words`` entries in use.

    Raises when a table's keys are not sorted, checked once per table. On a
    CUDA tensor the check is a device-side assert (no host read), which
    fails the process's CUDA context at a later synchronize; the port's
    scan-ordered tables always pass it."""
    for wtab in {id(wtab): wtab for wtab, _ in pairs}.values():
        torch._assert_async(wtab.sorted_ok, "compact word table is not sorted")
    return word_match_many([(wtab.wkeys, wtab.payload, wtab.n_words, q.contiguous())
                            for wtab, q in pairs])


def banded_offset_map(wtab: CompactWords, origins: torch.Tensor, coords: torch.Tensor,
                      valid: torch.Tensor, spec: GridSpec, *, table_level: int,
                      kernel_size: int, mode: str) -> torch.Tensor:
    """nbr int32[N, kernel_size³]: row indices into the level's table
    (offsets in itertools.product order, -1 = absent) from the compact word
    table, one kernel-D launch for all columns."""
    q, cols = word_queries(origins, coords, valid, spec, table_level=table_level,
                           kernel_size=kernel_size, mode=mode)
    return _column_rows(cols, banded_word_t4_many([(wtab, q)])[0])


# ---------------------------------------------------------------------------
# The pyramid
# ---------------------------------------------------------------------------

def level_tables(coords: torch.Tensor, num_valid: torch.Tensor, spec: GridSpec,
                 level_capacity: Sequence[int]):
    """(origins int32[B,3], [(coords int32[cap,4], num_valid int32[])] per
    level). Level l is the sorted unique set of the level l-1 table's cells
    at stride 2^l: one int64 cell key per row, a sort, and a compaction of
    the run starts (capacity overflow keeps the first in scan order)."""
    n0 = coords.shape[0]
    origins = batch_origins(coords, row_mask(n0, num_valid), spec.num_batches)
    tables = [(coords, num_valid)]
    for lvl in range(1, len(level_capacity)):
        prev_coords, prev_n = tables[-1]
        prev_valid = row_mask(prev_coords.shape[0], prev_n)
        strided = torch.cat([prev_coords[:, :1], (prev_coords[:, 1:] >> lvl) << lvl],
                            dim=1)
        b, c = _rel_cells(strided, origins, lvl, spec.num_batches)
        x_d, y_d, zc_d, _ = _packed_dims(spec, lvl)
        in_r = _in_dims(prev_valid, c, x_d, y_d, zc_d)
        key = ((b.long() * x_d + c[:, 0]) * y_d + c[:, 1]) * zc_d + c[:, 2]
        key = torch.where(in_r, key, INVALID_KEY)
        sk, order = torch.sort(key)
        prev = torch.cat([sk.new_full((1,), -1), sk[:-1]])
        sel, n_uniq = compact_first((sk != INVALID_KEY) & (sk != prev), order,
                                    level_capacity[lvl])
        out = torch.where((sel >= 0)[:, None], strided[sel.clamp_min(0)],
                          torch.full_like(strided[:1], PAD_COORD))
        tables.append((out, n_uniq))
    return origins, tables


def build_pyramid_grid(
    coords: torch.Tensor,
    num_valid: torch.Tensor,
    *,
    spec: GridSpec,
    num_levels: int = 4,
    conv1_kernel_size: int = 5,
    level_capacity: Sequence[int] | None = None,
) -> CoordinatePyramid:
    """Grid pyramid, drop-in for ``kernel_map.build_pyramid``.

    Requires level-0 valid rows unique, in scan order and inside the static
    extent (``quantize_grid`` guarantees it; ``fits_grid`` checks on the
    host). Builds the level tables, then each level's compact word table,
    then the queries of every map (10 for 4 levels and conv1 k5), and sends
    them all to kernel D's grouped entry in one launch. The level-0 k3 map
    is the inner column subset of the k5 map. The 2-cell halo holds kernels
    up to 5 wide; the JAX builder also takes wider conv1 kernels and then
    misses neighbours at the extent's edge, so the port refuses them."""
    if conv1_kernel_size not in (3, 5):
        raise ValueError(f"build_pyramid_grid: conv1_kernel_size must be 3 or 5 "
                         f"(the {HALO}-cell halo), got {conv1_kernel_size}")
    n0 = coords.shape[0]
    if level_capacity is None:
        level_capacity = tuple(max(256, n0 >> i) for i in range(num_levels))
    origins, tables = level_tables(coords, num_valid, spec, level_capacity[:num_levels])
    valid = [row_mask(c.shape[0], n) for c, n in tables]

    # every map of the pyramid: name -> (table level, query level, kernel, mode)
    maps = {"k5": (0, 0, conv1_kernel_size, "same")}
    for lvl in range(1, num_levels):
        maps[f"down{lvl}"] = (lvl - 1, lvl, 3, "down")
        maps[f"same{lvl}"] = (lvl, lvl, 3, "same")
        maps[f"up{lvl - 1}"] = (lvl, lvl - 1, 3, "up")

    wtabs = [compact_words(c, v, origins, spec, lvl)
             for lvl, ((c, _), v) in enumerate(zip(tables, valid))]
    queries = {name: word_queries(origins, tables[lvl][0], valid[lvl], spec,
                                  table_level=table_level, kernel_size=kernel_size,
                                  mode=mode)
               for name, (table_level, lvl, kernel_size, mode) in maps.items()}
    t4s = banded_word_t4_many([(wtabs[maps[name][0]], q)
                               for name, (q, _) in queries.items()])
    nbr = {name: _column_rows(cols, t4)
           for (name, (_, cols)), t4 in zip(queries.items(), t4s)}

    k5 = nbr["k5"]
    if conv1_kernel_size == 3:
        k3_l0 = k5
    else:
        k3_l0 = k5.reshape(-1, 5, 5, 5)[:, 1:4, 1:4, 1:4].reshape(-1, 27)
    levels = []
    for lvl, (c, n) in enumerate(tables):
        levels.append(LevelMaps(c, n, k3_l0 if lvl == 0 else nbr[f"same{lvl}"],
                                nbr.get(f"down{lvl}"), nbr.get(f"up{lvl}")))
    return CoordinatePyramid(tuple(levels), k5)
