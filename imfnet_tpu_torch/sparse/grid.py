"""Grid-extent voxel quantization and the packed-grid kernel-map builder
(``imfnet_tpu.sparse.grid``).

``quantize_grid`` voxelizes raw points inside a static per-batch extent;
its compaction tail runs in plain PyTorch (``compact_impl="auto"``) or
through kernel C (``"kernel"``, ``sparse.quant_kernel``).

``build_pyramid_grid`` builds the coordinate pyramid from a bit-packed
occupancy index: per level, z-bitmask words over the halo'd extent,

    word w = (b, cx, cy, cz >> 5)    bits[w] bit (cz & 31) = occupied
    rank[w] = occupied cells in the words before w (scan order)

Level tables are in scan order, so the row of an occupied cell is
``rank[w] + popcount(bits[w] & below_bit)``, and one 2-word window (a word
and its successor in the same (x, y) column) answers every z-offset of a
kernel column. The builders (``map_impl``) differ only in how they read
the windows, and all give the tables of the search builder
(``sparse.kernel_map.build_pyramid``) for in-extent inputs, which is all
``quantize_grid`` produces:
- "packed": a dense table over the whole extent (``pack_level``), one row
  gather per (row, (dx, dy) column);
- "ywide": the dense table widened in y (``widen_y``), one gather per dx
  column, two for an 'up' map;
- "transpose": the dense table for 'down' maps and half of each 'same' map
  (``packed_offset_map_sym``); the rest comes from scatters of those maps
  (``transpose_offset_map``);
- "banded" (and "auto"): the compact table of occupied words
  (``compact_words``) through kernel D's grouped entry
  (``sparse.word_map_kernel.word_match_many``): the queries of all of a
  pyramid's maps are built first and matched in one launch.
The unpacked row grid (``build_grid``, ``grid_lookup``) is kept as a simple
oracle.

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
GRID_MAP_IMPLS = ("auto", "banded", "packed", "ywide", "transpose")

# column indices of the inner 3x3x3 offsets within the 5x5x5 product order
K3_IN_K5 = [((dx + 2) * 5 + (dy + 2)) * 5 + (dz + 2)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


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
    if compact_impl not in ("auto", "kernel"):
        raise ValueError(f"quantize_grid: compact_impl must be 'auto' or "
                         f"'kernel', got {compact_impl!r}")
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
# Dense packed occupancy index (map_impl="packed", and the oracle)
# ---------------------------------------------------------------------------

class PackedLevel(NamedTuple):
    """Packed occupancy index of one level's coordinate table.

    table int32[W, 4]: (bits[w], bits[w+1], rank[w], rank[w+1]), where the
    w+1 bits are zero at the last word of each z-column so a 2-word window
    never reads a neighbouring (x, y) column.
    """

    table: torch.Tensor
    dims: Tuple[int, int, int, int]  # (X, Y, Zc, Zw) halo'd cell dims


def pack_words(coords: torch.Tensor, valid: torch.Tensor, origins: torch.Tensor,
               spec: GridSpec, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bits int64[W] 32-bit words, rank int32[W] exclusive prefix popcount
    in scan order). Rows must be cell-unique."""
    dims = _packed_dims(spec, level)
    x_d, y_d, zc_d, zw_d = dims
    num_w = spec.num_batches * x_d * y_d * zw_d
    b, c = _rel_cells(coords, origins, level, spec.num_batches)
    in_r = _in_dims(valid, c, x_d, y_d, zc_d)
    w = _word_index(b, c[:, 0], c[:, 1], c[:, 2] >> 5, dims)
    w = torch.where(in_r, w, num_w)
    bit = torch.ones_like(w) << (c[:, 2] & 31).long()
    bits = torch.zeros((num_w + 1,), dtype=torch.int64, device=coords.device)
    bits = bits.scatter_add_(0, w, bit)[:num_w] & WORD_MASK
    pc = popcount32(bits)
    rank = (torch.cumsum(pc, 0) - pc).to(torch.int32)
    return bits, rank


def pack_level(coords: torch.Tensor, valid: torch.Tensor, origins: torch.Tensor,
               spec: GridSpec, level: int) -> PackedLevel:
    """The dense packed occupancy/rank index of one level table (scan
    order, unique, in extent)."""
    dims = _packed_dims(spec, level)
    zw_d = dims[3]
    bits, rank = pack_words(coords, valid, origins, spec, level)
    num_w = bits.shape[0]
    last_in_col = (torch.arange(num_w, device=bits.device) % zw_d) == zw_d - 1
    bits1 = torch.where(last_in_col, 0, torch.roll(bits, -1))
    rank1 = torch.roll(rank, -1)
    rank1[-1] = rank[-1] + popcount32(bits[-1]).to(torch.int32)
    table = torch.stack([_as_int32(bits), _as_int32(bits1), rank, rank1], dim=1)
    return PackedLevel(table, dims)


def _window_rows_vec(t4: torch.Tensor, zrels: torch.Tensor, zlo_w: torch.Tensor):
    """Row and existence of the cells at z-cells ``zrels`` [N, 1, kz], read
    from the 2-word windows ``t4`` int32[N, ncol, 4] anchored at z-word
    ``zlo_w`` [N, 1]. Returns (exists bool[N, ncol, kz], row int32[N, ncol, kz])."""
    sel = ((zrels >> 5) - zlo_w[..., None]) == 0
    bits = torch.where(sel, t4[..., 0:1], t4[..., 1:2]).long() & WORD_MASK
    rank = torch.where(sel, t4[..., 2:3], t4[..., 3:4])
    p = (zrels & 31).long()
    exists = ((bits >> p) & 1).bool()
    below = bits & ((torch.ones_like(p) << p) - 1)
    return exists, rank + popcount32(below).to(torch.int32)


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
    """nbr int32[N, ncol·kz] from the columns' windows ``t4`` [N, ncol, 4],
    -1 where absent."""
    exists, row = _window_rows_vec(t4, cols.zrels, cols.zlo_w)
    ok = cols.ok_xy[:, :, None] & exists
    if cols.aligned is not None:
        ok = ok & cols.aligned
    return torch.where(ok, row, -1).reshape(row.shape[0], -1)


def packed_offset_map(pt: PackedLevel, origins: torch.Tensor, coords: torch.Tensor,
                      valid: torch.Tensor, spec: GridSpec, *, table_level: int,
                      kernel_size: int, mode: str) -> torch.Tensor:
    """nbr int32[N, kernel_size³]: row indices into the packed level's table
    (offsets in itertools.product order, -1 = absent), one gather of the
    dense table for every (row, (dx, dy) column)."""
    cols = _offset_columns(origins, coords, valid, spec, table_level=table_level,
                           kernel_size=kernel_size, mode=mode)
    w0 = torch.where(cols.ok_xy, cols.w0, 0).clamp(0, pt.table.shape[0] - 1)
    return _column_rows(cols, pt.table[w0])


def scan_position(bits: torch.Tensor, rank: torch.Tensor, coords: torch.Tensor,
                  valid: torch.Tensor, origins: torch.Tensor, spec: GridSpec,
                  level: int) -> torch.Tensor:
    """int32 scan-order position of each row's own cell in the packed words
    (``pack_words``), -1 where the cell is absent or outside the extent."""
    dims = _packed_dims(spec, level)
    x_d, y_d, zc_d, _ = dims
    b, c = _rel_cells(coords, origins, level, spec.num_batches)
    in_r = _in_dims(valid, c, x_d, y_d, zc_d)
    w = _word_index(b, c[:, 0], c[:, 1], c[:, 2] >> 5, dims)
    w = torch.where(in_r, w, 0).clamp(0, bits.shape[0] - 1)
    bw = bits[w] & WORD_MASK
    p = (c[:, 2] & 31).long()
    exists = ((bw >> p) & 1).bool()
    below = bw & ((torch.ones_like(p) << p) - 1)
    pos = rank[w] + popcount32(below).to(torch.int32)
    return torch.where(in_r & exists, pos, -1)


# ---------------------------------------------------------------------------
# The unpacked dense row grid (quantize-time self-lookups, a simple oracle)
# ---------------------------------------------------------------------------

def _grid_flat(coords: torch.Tensor, origins: torch.Tensor, spec: GridSpec, level: int,
               b: torch.Tensor, ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat int64 cell index, in-extent mask) of each row in the unpacked
    grid of ``level``, given its clamped batch ``b`` and a validity mask."""
    X, Y, Z = spec.level_dims(level)
    c = (coords[:, 1:] >> level) - (origin_lookup(origins, b) >> level)
    ok = (ok & (c >= 0).all(dim=1) & (c[:, 0] < X) & (c[:, 1] < Y) & (c[:, 2] < Z))
    flat = ((b.long() * X + c[:, 0]) * Y + c[:, 1]) * Z + c[:, 2]
    return flat, ok


def build_grid(coords: torch.Tensor, valid: torch.Tensor, origins: torch.Tensor,
               spec: GridSpec, level: int) -> torch.Tensor:
    """Flat int32 grid of row indices over the level's extent, -1 where
    empty, shape [B·X·Y·Z]. Of rows in one cell the lowest wins."""
    X, Y, Z = spec.level_dims(level)
    B = spec.num_batches
    b = coords[:, 0].clamp_max(B - 1).clamp_min(0)
    flat, ok = _grid_flat(coords, origins, spec, level, b, valid)
    size = B * X * Y * Z
    flat = torch.where(ok, flat, size)
    rows = torch.arange(coords.shape[0], dtype=torch.int32, device=coords.device)
    sentinel = torch.iinfo(torch.int32).max
    grid = torch.full((size + 1,), sentinel, dtype=torch.int32, device=coords.device)
    grid = grid.scatter_reduce(0, flat, rows, reduce="amin")[:size]
    return torch.where(grid == sentinel, -1, grid)


def grid_lookup(grid: torch.Tensor, origins: torch.Tensor, queries: torch.Tensor,
                q_valid: torch.Tensor, spec: GridSpec, level: int,
                check_alignment: bool = False) -> torch.Tensor:
    """The grid's row per query int32[Q,4], or -1. ``check_alignment``
    also misses queries off the level's lattice."""
    b = queries[:, 0].clamp(0, spec.num_batches - 1)
    ok = q_valid
    if check_alignment:
        ok = ok & ((queries[:, 1:] & ((1 << level) - 1)) == 0).all(dim=1)
    flat, ok = _grid_flat(queries, origins, spec, level, b, ok)
    return torch.where(ok, grid[torch.where(ok, flat, 0)], -1)


def _offset_map(grid: torch.Tensor, origins: torch.Tensor, coords: torch.Tensor,
                valid: torch.Tensor, offsets: np.ndarray, spec: GridSpec, level: int,
                check_alignment: bool = False) -> torch.Tensor:
    """nbr int32[N, K]: one grid lookup for every row and offset ``[K, 3]``."""
    offs = torch.as_tensor(np.asarray(offsets), dtype=torch.int32, device=coords.device)
    n, k = coords.shape[0], offs.shape[0]
    q = coords[:, None, 1:] + offs[None]
    qb = coords[:, None, :1].expand(n, k, 1)
    queries = torch.cat([qb, q], dim=2).reshape(n * k, 4)
    nbr = grid_lookup(grid, origins, queries, valid.repeat_interleave(k), spec, level,
                      check_alignment=check_alignment)
    return nbr.reshape(n, k)


# ---------------------------------------------------------------------------
# y-widened dense table (map_impl="ywide")
# ---------------------------------------------------------------------------

def widen_y(pt: PackedLevel, r: int) -> torch.Tensor:
    """int32[W, 4·(2r+1)]: row w holds the windows of words w + d·Zw for d
    in -r..r, zero (absent) beyond the table's ends. A step of Zw words is
    one cell in y, so one row gather fetches the windows of every dy."""
    table, shift = pt.table, pt.dims[3]
    n_w = table.shape[0]
    parts = []
    for d in range(-r, r + 1):
        pad = table.new_zeros((min(abs(d) * shift, n_w), 4))
        if d < 0:
            parts.append(torch.cat([pad, table[:n_w - pad.shape[0]]]))
        elif d > 0:
            parts.append(torch.cat([table[pad.shape[0]:], pad]))
        else:
            parts.append(table)
    return torch.cat(parts, dim=1)


def _wide_radius(wide: torch.Tensor) -> int:
    return (wide.shape[1] // 4 - 1) // 2


def packed_offset_map_ywide(pt: PackedLevel, wide: torch.Tensor, origins: torch.Tensor,
                            coords: torch.Tensor, valid: torch.Tensor, spec: GridSpec, *,
                            table_level: int, kernel_size: int, mode: str) -> torch.Tensor:
    """``packed_offset_map`` through the y-widened table ``widen_y(pt, rw)``
    (rw at least kernel_size // 2): one row gather per dx column instead of
    one per (dx, dy); mode 'up' takes two gathers (``_ywide_up_map``)."""
    if mode == "up":
        return _ywide_up_map(pt, wide, origins, coords, valid, spec,
                             table_level=table_level, kernel_size=kernel_size)
    if mode not in ("same", "down"):
        raise ValueError(f"mode must be 'same', 'down' or 'up', got {mode!r}")
    x_d, y_d, zc_d, _ = pt.dims
    r = kernel_size // 2
    rw = _wide_radius(wide)
    if rw < r:
        raise ValueError(f"packed_offset_map_ywide: the table is widened by {rw}, "
                         f"the kernel needs {r}")
    b, base = _rel_cells(coords, origins, table_level, spec.num_batches)
    base_ok = (valid & (base >= r).all(dim=1)
               & (base[:, 0] < x_d - r) & (base[:, 1] < y_d - r) & (base[:, 2] < zc_d - r))
    d = torch.arange(-r, r + 1, dtype=torch.int32, device=coords.device)
    zlo_w = (base[:, 2:3] - r) >> 5                                  # [N, 1]
    w0 = _word_index(b[:, None], base[:, 0:1] + d[None], base[:, 1:2], zlo_w, pt.dims)
    w0 = torch.where(base_ok[:, None], w0, 0).clamp(0, wide.shape[0] - 1)
    g = wide[w0].reshape(coords.shape[0], 2 * r + 1, 2 * rw + 1, 4)
    t4 = g[:, :, rw - r: rw + r + 1].reshape(coords.shape[0], -1, 4)  # dx slowest, dy
    exists, row = _window_rows_vec(t4, base[:, 2:3, None] + d[None, None], zlo_w)
    return torch.where(base_ok[:, None, None] & exists, row, -1).reshape(
        coords.shape[0], -1)


def _ywide_up_map(pt: PackedLevel, wide: torch.Tensor, origins: torch.Tensor,
                  coords: torch.Tensor, valid: torch.Tensor, spec: GridSpec, *,
                  table_level: int, kernel_size: int) -> torch.Tensor:
    """The 'up' k3 map in two row gathers: ``(m + dx) >> 1`` takes only two
    coarse x cells across dx in {-1, 0, 1}, so the widened rows of those two
    cells (anchored at the query's clipped coarse y) hold every (dx, dy)
    target; parity picks the row and the dy window."""
    if kernel_size != 3:
        raise ValueError(f"_ywide_up_map: kernel_size must be 3, got {kernel_size}")
    x_d, y_d, zc_d, _ = pt.dims
    rw = _wide_radius(wide)
    if rw < 1:
        raise ValueError("_ywide_up_map: the table must be widened by at least 1")
    n = coords.shape[0]
    dev = coords.device
    b = coords[:, 0].clamp(0, spec.num_batches - 1)
    m = coords[:, 1:] >> (table_level - 1)
    o_cell = origin_lookup(origins, b) >> table_level
    zlo = ((m[:, 2:3] - 1) >> 1) - o_cell[:, 2:3] + HALO              # [N, 1]
    zlo_w = zlo >> 5
    ok_z = valid[:, None] & (zlo >= 0) & (zlo < zc_d - 1)
    cy_g = ((m[:, 1:2] >> 1) - o_cell[:, 1:2] + HALO).clamp(0, y_d - 1)
    cx_lo = ((m[:, 0:1] - 1) >> 1) - o_cell[:, 0:1] + HALO
    e = torch.arange(2, dtype=torch.int32, device=dev)[None]         # [1, 2]
    cx = cx_lo + e
    ok_g = ok_z & (cx >= 0) & (cx < x_d)
    w0 = _word_index(b[:, None], cx, cy_g, zlo_w, pt.dims)
    w0 = torch.where(ok_g, w0, 0).clamp(0, wide.shape[0] - 1)
    rows2 = wide[w0].reshape(n, 2, 2 * rw + 1, 4)
    d = torch.arange(-1, 2, dtype=torch.int32, device=dev)[None]     # [1, 3]
    zq = m[:, 2:3, None] + d[:, None]                                # [N, 1, 3]
    zrels = (zq >> 1) - o_cell[:, 2:3, None] + HALO
    az = (zq & 1) == 0
    cx_t = ((m[:, 0:1] + d) >> 1) - o_cell[:, 0:1] + HALO            # [N, 3] over dx
    g = rows2[torch.arange(n, device=dev)[:, None], (cx_t - cx_lo == 1).long()]
    cy_t = ((m[:, 1:2] + d) >> 1) - o_cell[:, 1:2] + HALO            # [N, 3] over dy
    slot = cy_t - cy_g + rw
    slot = torch.where((slot >= 0) & (slot <= 2 * rw), slot, rw).long()
    t4 = g[torch.arange(n, device=dev)[:, None, None],
           torch.arange(3, device=dev)[None, :, None], slot[:, None, :]]  # [N, 3, 3, 4]
    ok_x = (cx_t >= 0) & (cx_t < x_d) & (((m[:, 0:1] + d) & 1) == 0)
    ok_y = (cy_t >= 0) & (cy_t < y_d) & (((m[:, 1:2] + d) & 1) == 0)
    ok_col = (ok_z & ok_x)[:, :, None] & ok_y[:, None, :]            # [N, 3, 3]
    exists, row = _window_rows_vec(t4.reshape(n, 9, 4), zrels, zlo_w)
    ok = ok_col.reshape(n, 9, 1) & az & exists
    return torch.where(ok, row, -1).reshape(n, 27)


# ---------------------------------------------------------------------------
# Scatter-derived maps (map_impl="transpose")
# ---------------------------------------------------------------------------

def _scatter_inverse(src_cols: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Inverse of an offset-map column block through one scatter: maps obey
    m[q, k] = p ⟺ m'[p, K-1-k] = q, m' the map of the negated offsets. Given
    ``src_cols[Q, C]`` for offsets δ_0..δ_{C-1}, returns ``inv[n_rows, C]``
    for -δ_{C-1}..-δ_0 (inv[src_cols[q, C-1-j], j] = q), -1 where unmatched.
    Coordinates are unique, so no two entries land on one slot; the unmatched
    ones go to a padding row past the end, which is cut off."""
    q_n, c_n = src_cols.shape
    src = src_cols.flip(1).long()
    rows = torch.where(src >= 0, src, n_rows)
    cols = torch.arange(c_n, device=src.device)[None]
    q = torch.arange(q_n, dtype=torch.int32, device=src.device)[:, None].expand(q_n, c_n)
    out = torch.full(((n_rows + 1) * c_n,), -1, dtype=torch.int32, device=src.device)
    out = out.scatter(0, (rows * c_n + cols).reshape(-1), q.reshape(-1))
    return out[:n_rows * c_n].reshape(n_rows, c_n)


def transpose_offset_map(down: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The 'up' map of the finer level from the 'down' map of the coarser:
    down[q, k] = j ⟺ up[j, K-1-k] = q."""
    return _scatter_inverse(down, n_rows)


def packed_offset_map_sym(pt: PackedLevel, origins: torch.Tensor, coords: torch.Tensor,
                          valid: torch.Tensor, spec: GridSpec, *, table_level: int,
                          kernel_size: int) -> torch.Tensor:
    """The 'same' map with half the probes: a same map is its own transpose,
    so only the offsets before the centre (product order) are looked up; the
    centre is the identity and the other half is ``_scatter_inverse``'s."""
    cols = _offset_columns(origins, coords, valid, spec, table_level=table_level,
                           kernel_size=kernel_size, mode="same")
    half_cols = (kernel_size * kernel_size) // 2 + 1   # (dx, dy) up to (0, 0)
    w0 = torch.where(cols.ok_xy, cols.w0, 0).clamp(0, pt.table.shape[0] - 1)
    probed = _column_rows(cols._replace(w0=w0[:, :half_cols], ok_xy=cols.ok_xy[:, :half_cols]),
                          pt.table[w0[:, :half_cols]])
    half = probed[:, :kernel_size ** 3 // 2]
    n = coords.shape[0]
    centre = torch.where(valid, torch.arange(n, dtype=torch.int32, device=coords.device), -1)
    return torch.cat([half, centre[:, None], _scatter_inverse(half, n)], dim=1)


# ---------------------------------------------------------------------------
# Compact occupied-word table (map_impl="banded", kernel D)
# ---------------------------------------------------------------------------

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


def banded_word_t4(wtab: CompactWords, q: torch.Tensor) -> torch.Tensor:
    """``banded_word_t4_many`` for one table and one query tensor."""
    return banded_word_t4_many([(wtab, q)])[0]


def banded_offset_map(wtab: CompactWords, origins: torch.Tensor, coords: torch.Tensor,
                      valid: torch.Tensor, spec: GridSpec, *, table_level: int,
                      kernel_size: int, mode: str) -> torch.Tensor:
    """``packed_offset_map`` from the compact word table: one kernel-D
    launch for all columns, no dense table."""
    q, cols = word_queries(origins, coords, valid, spec, table_level=table_level,
                           kernel_size=kernel_size, mode=mode)
    return _column_rows(cols, banded_word_t4(wtab, q))


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
    map_impl: str = "auto",
) -> CoordinatePyramid:
    """Packed-grid pyramid, drop-in for ``kernel_map.build_pyramid``.

    Requires level-0 valid rows unique, in scan order and inside the static
    extent (``quantize_grid`` guarantees it; ``fits_grid`` checks on the
    host). ``map_impl`` is one of ``GRID_MAP_IMPLS``; "auto" is "banded"
    (the JAX package resolves it to "ywide"). "banded" builds the queries
    of all maps, 10 for 4 levels and conv1 k5, first and sends them to
    kernel D's grouped entry in one launch; "transpose" builds the 'down'
    maps first and derives each level's 'up' map from the next level's. The
    level-0 k3 map is the inner column subset of the k5 map. The 2-cell
    halo holds kernels up to 5 wide; the JAX builder also takes wider conv1
    kernels and then misses neighbours at the extent's edge, so the port
    refuses them."""
    if conv1_kernel_size not in (3, 5):
        raise ValueError(f"build_pyramid_grid: conv1_kernel_size must be 3 or 5 "
                         f"(the {HALO}-cell halo), got {conv1_kernel_size}")
    if map_impl not in GRID_MAP_IMPLS:
        raise ValueError(f"build_pyramid_grid: map_impl must be one of "
                         f"{GRID_MAP_IMPLS}, got {map_impl!r}")
    if map_impl == "auto":
        map_impl = "banded"
    n0 = coords.shape[0]
    if level_capacity is None:
        level_capacity = tuple(max(256, n0 >> i) for i in range(num_levels))
    origins, tables = level_tables(coords, num_valid, spec, level_capacity[:num_levels])
    valid = [row_mask(c.shape[0], n) for c, n in tables]

    # every map of the pyramid: name -> (table level, query level, kernel,
    # mode); a level's 'up' map follows the next level's 'down' map, from
    # which "transpose" derives it
    maps = {"k5": (0, 0, conv1_kernel_size, "same")}
    for lvl in range(1, num_levels):
        maps[f"down{lvl}"] = (lvl - 1, lvl, 3, "down")
        maps[f"same{lvl}"] = (lvl, lvl, 3, "same")
        maps[f"up{lvl - 1}"] = (lvl, lvl - 1, 3, "up")

    def call(fn, m, *lead):
        table_level, lvl, kernel_size, mode = m
        return fn(*lead, origins, tables[lvl][0], valid[lvl], spec,
                  table_level=table_level, kernel_size=kernel_size, mode=mode)

    def packs():
        return [pack_level(c, v, origins, spec, lvl)
                for lvl, ((c, _), v) in enumerate(zip(tables, valid))]

    if map_impl == "packed":
        pts = packs()
        nbr = {name: call(packed_offset_map, m, pts[m[0]]) for name, m in maps.items()}
    elif map_impl == "ywide":
        pts = packs()
        wides = [widen_y(pt, conv1_kernel_size // 2 if lvl == 0 else 1)
                 for lvl, pt in enumerate(pts)]
        nbr = {name: call(packed_offset_map_ywide, m, pts[m[0]], wides[m[0]])
               for name, m in maps.items()}
    elif map_impl == "transpose":
        pts = packs()
        nbr = {}
        for name, m in maps.items():
            table_level, lvl, kernel_size, mode = m
            if mode == "same":
                nbr[name] = packed_offset_map_sym(
                    pts[table_level], origins, tables[lvl][0], valid[lvl], spec,
                    table_level=table_level, kernel_size=kernel_size)
            elif mode == "down":
                nbr[name] = call(packed_offset_map, m, pts[table_level])
            else:
                nbr[name] = transpose_offset_map(nbr[f"down{lvl + 1}"],
                                                 tables[lvl][0].shape[0])
    else:
        wtabs = [compact_words(c, v, origins, spec, lvl)
                 for lvl, ((c, _), v) in enumerate(zip(tables, valid))]
        queries = {name: call(word_queries, m) for name, m in maps.items()}
        t4s = banded_word_t4_many([(wtabs[maps[name][0]], q)
                                   for name, (q, _) in queries.items()])
        nbr = {name: _column_rows(cols, t4)
               for (name, (_, cols)), t4 in zip(queries.items(), t4s)}

    k5 = nbr["k5"]
    if conv1_kernel_size == 3:
        k3_l0 = k5
    else:
        # the K3_IN_K5 columns: the inner 3³ of the 5³ offsets, in order
        k3_l0 = k5.reshape(-1, 5, 5, 5)[:, 1:4, 1:4, 1:4].reshape(-1, 27)
    levels = []
    for lvl, (c, n) in enumerate(tables):
        levels.append(LevelMaps(c, n, k3_l0 if lvl == 0 else nbr[f"same{lvl}"],
                                nbr.get(f"down{lvl}"), nbr.get(f"up{lvl}")))
    return CoordinatePyramid(tuple(levels), k5)
