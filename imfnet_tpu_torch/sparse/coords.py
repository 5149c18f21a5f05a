"""Coordinate engine for the sparse-voxel representation.

A sparse tensor is ``SparseVoxels(coords[N,1+D] int32, feats[N,C], num_valid)``
with ``coords = (batch, x, y, z)`` in voxel units (D = 3) or, for the 6-D
correspondence tensors of ``eval.dgr``, ``(batch, u1, ..., u6)`` (D = 6).
The dimension is read from the coordinates' width. Rows ``>= num_valid``
are padding: their coords are ``PAD_COORD`` and their feats are zero. Valid
rows are kept sorted by key, i.e. lexicographic in (batch, coordinates).

A 3-D coordinate's key is one int64,

    key = ((batch << 16 | x + 2^15) << 32) | ((y + 2^15) << 16 | z + 2^15)

the (hi, lo) uint32 pair of ``imfnet_tpu.sparse.coords.make_keys`` read as one
number, so keys order rows exactly as the JAX package's keys do. A 6-D key
packs ``KEY6_BITS`` (10) bits an axis after a shift of 2^9 and the batch in
the two bits above them, ``batch << 60 | Σ_a (u_a + 2^9) << 10 (5 - a)``:
it orders rows lexicographically and tests membership exactly. A row is in
range (``in_key_range``) with its batch in 0..3 and every axis within
``KEY6_MARGIN`` (8, the largest offset of a 4-level pyramid's maps) of the
10 bits' ends, [-504, 503], so that every query a map makes of it, the row
plus an offset, is a field-wise sum that neither borrows nor carries: its
key is the row's key plus the offset's (``offset_map6``). A 6-D row out of
range is never aliased: a query gets ``PAD_QUERY_KEY`` (it misses, as no
table row can lie there) and a table row ``PAD_TABLE_KEY`` (it drops out of
the table), and ``out_of_range`` counts such rows for the caller to report.
Table padding gets ``PAD_TABLE_KEY`` (sorts last); padded queries get
``PAD_QUERY_KEY``, which never equals a table key, so they always miss.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

COORD_SHIFT = 1 << 15
PAD_COORD = -(1 << 20)
PAD_TABLE_KEY = (1 << 63) - 1
PAD_QUERY_KEY = (1 << 63) - 2
KEY6_BITS = 10                    # bits an axis of a 6-D key
KEY6_SHIFT = 1 << (KEY6_BITS - 1)
KEY6_BATCHES = 4                  # batches a 6-D key holds (two bits)
KEY6_MARGIN = 8                   # room kept at each end of an axis for offsets


class SparseVoxels(NamedTuple):
    """Padded, statically-shaped sparse voxel tensor.

    coords:    int32[N, 4]  (batch, x, y, z), valid rows sorted by key,
               padding rows = PAD_COORD.
    feats:     [N, C] features; padding rows are zero.
    num_valid: int32[] number of valid rows (a 0-dim tensor).
    """

    coords: torch.Tensor
    feats: torch.Tensor
    num_valid: torch.Tensor

    @property
    def n_padded(self) -> int:
        return self.coords.shape[0]

    def mask(self) -> torch.Tensor:
        """bool[N] validity mask."""
        return row_mask(self.coords.shape[0], self.num_valid)


def row_mask(n_padded: int, num_valid: torch.Tensor) -> torch.Tensor:
    """bool[n_padded]: rows below ``num_valid``."""
    return torch.arange(n_padded, device=num_valid.device) < num_valid


def coord_dim(coords: torch.Tensor) -> int:
    """D of coordinates ``[N, 1 + D]``: 3 or 6."""
    d = coords.shape[-1] - 1
    if d not in (3, 6):
        raise ValueError(f"coordinates must be (batch, 3 or 6 axes); got width {d + 1}")
    return d


def in_key_range(coords: torch.Tensor) -> torch.Tensor:
    """bool[N]: rows whose key is exact, and so are the keys of every
    query a map makes of them (a 6-D row within ``KEY6_SHIFT -
    KEY6_MARGIN`` of the origin on every axis, batch in [0,
    ``KEY6_BATCHES``)); every 3-D row (its keys keep the JAX package's
    16-bit wrap)."""
    if coord_dim(coords) == 3:
        return torch.ones(coords.shape[0], dtype=torch.bool, device=coords.device)
    c = coords.to(torch.int64)
    u = c[:, 1:] + KEY6_SHIFT
    return ((c[:, 0] >= 0) & (c[:, 0] < KEY6_BATCHES)
            & ((u >= KEY6_MARGIN) & (u < (1 << KEY6_BITS) - KEY6_MARGIN)).all(dim=1))


def out_of_range(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int64[]: valid rows whose key would not be exact (``in_key_range``)."""
    return (valid & ~in_key_range(coords)).sum()


def _keys6(c: torch.Tensor) -> torch.Tensor:
    """The 6-D key of int64 coordinates [..., 7] that are in range."""
    key = c[..., 0]
    for a in range(1, 7):
        key = (key << KEY6_BITS) | (c[..., a] + KEY6_SHIFT)
    return key


def make_keys(coords: torch.Tensor, valid: torch.Tensor, *,
              is_table: bool) -> torch.Tensor:
    """int64 keys of int32 coords [N,4] or [N,7]; invalid rows get
    sentinels, and so do 6-D rows out of the key's range."""
    pad = PAD_TABLE_KEY if is_table else PAD_QUERY_KEY
    if coord_dim(coords) == 6:
        key = _keys6(coords.to(torch.int64))
        return torch.where(valid & in_key_range(coords), key, torch.full_like(key, pad))
    c = coords.to(torch.int64)
    b = c[:, 0]
    x = (c[:, 1] + COORD_SHIFT) & 0xFFFF
    y = (c[:, 2] + COORD_SHIFT) & 0xFFFF
    z = (c[:, 3] + COORD_SHIFT) & 0xFFFF
    key = (((b << 16) | x) << 32) | (y << 16) | z
    return torch.where(valid, key, torch.full_like(key, pad))


def lookup(table_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """Exact membership search: for each query key, its row in the sorted
    table, or -1 if absent (int32, the shape of ``query_keys``)."""
    n = table_keys.shape[0]
    pos = torch.searchsorted(table_keys, query_keys.reshape(-1))
    safe = pos.clamp_max(n - 1)
    found = (pos < n) & (table_keys[safe] == query_keys.reshape(-1))
    out = torch.where(found, pos, torch.full_like(pos, -1))
    return out.to(torch.int32).reshape(query_keys.shape)


def compact_first(first: torch.Tensor, order: torch.Tensor,
                  n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream compaction without a host sync: the ``order`` entries where
    ``first`` is set, in their order, into ``n_out`` slots (-1 beyond).
    Returns (sel int64[n_out], count int32[] clamped to n_out)."""
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    tgt = torch.where(first & (pos < n_out), pos, torch.full_like(pos, n_out))
    sel = torch.full((n_out + 1,), -1, dtype=torch.int64, device=order.device)
    sel.scatter_(0, tgt, order.to(torch.int64))
    count = first.sum().clamp_max(n_out).to(torch.int32)
    return sel[:n_out], count


def unique_voxels(coords: torch.Tensor, valid: torch.Tensor, n_out: int):
    """Deduplicate voxel coordinates, keeping the first occurrence per voxel.

    Returns (unique_coords int32[n_out,1+D] sorted by key, sel int64[n_out]
    index of the first-occurring input row per voxel or -1, n_unique int32[]).
    """
    keys = make_keys(coords, valid, is_table=True)
    s_keys, order = torch.sort(keys, stable=True)
    prev = torch.cat([s_keys.new_full((1,), -1), s_keys[:-1]])
    first = (s_keys != PAD_TABLE_KEY) & (s_keys != prev)
    sel, n_unique = compact_first(first, order, n_out)
    ok = sel >= 0
    uniq = torch.where(ok[:, None], coords[sel.clamp_min(0)],
                       torch.full_like(coords[:1], PAD_COORD))
    return uniq, sel, n_unique


def voxel_cells(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """int32[N,3] ``floor(xyz / voxel_size)`` by true f32 division, as the
    JAX package computes it. The divisor is a tensor on ``xyz``'s device: a
    CUDA tensor divided by a Python float is multiplied by the reciprocal
    instead, which can move a point lying on a cell boundary."""
    v = torch.full((), voxel_size, dtype=xyz.dtype, device=xyz.device)
    return torch.floor(xyz / v).to(torch.int32)


def quantize(xyz: torch.Tensor, feats: torch.Tensor, valid: torch.Tensor,
             voxel_size: float, n_out: int,
             batch_index: torch.Tensor | int = 0):
    """Voxelize points with no extent: ``floor(xyz / voxel)``, first
    occurrence wins (`util/misc.py:82-87`). Keys pack 16 bits per axis
    after a shift of 2^15 (``make_keys``), ±32 767 voxels from the origin.

    Returns (SparseVoxels, sel int64[n_out] (-1 in padding), xyz_down[n_out,3]),
    rows sorted by key; on overflow the first ``n_out`` voxels are kept."""
    v = voxel_cells(xyz, voxel_size)
    if isinstance(batch_index, int):
        b = torch.full((v.shape[0],), batch_index, dtype=torch.int32, device=xyz.device)
    else:
        b = batch_index.to(torch.int32)
    coords4 = torch.cat([b[:, None], v], dim=1)
    uniq, sel, n_unique = unique_voxels(coords4, valid, n_out)
    ok = sel >= 0
    ss = sel.clamp_min(0)
    f = torch.where(ok[:, None], feats[ss], torch.zeros_like(feats[:1]))
    xyz_down = torch.where(ok[:, None], xyz[ss], torch.zeros_like(xyz[:1]))
    return SparseVoxels(uniq, f, n_unique), sel, xyz_down


def stride_coords(coords: torch.Tensor, valid: torch.Tensor, stride: int,
                  n_out: int):
    """Output coordinates of a stride-``s`` downsampling conv: the unique set
    of ``floor(c / s) * s`` over valid inputs, sorted.

    Every axis is strided, at any D. Returns (out_coords int32[n_out,1+D],
    n_out_valid int32[])."""
    strided = torch.div(coords[:, 1:], stride, rounding_mode="floor") * stride
    c = torch.cat([coords[:, :1], strided], dim=1)
    uniq, _, n_unique = unique_voxels(c, valid, n_out)
    return uniq, n_unique


def batch_segments(coords: torch.Tensor, valid: torch.Tensor, max_batch: int):
    """Start offset and length (int64[max_batch] each) of each batch's
    contiguous row segment; valid rows are key-sorted, so batch b occupies
    rows [starts[b], starts[b] + lengths[b])."""
    b = torch.where(valid, coords[:, 0].to(torch.int64),
                    torch.full_like(coords[:, 0], max_batch, dtype=torch.int64))
    counts = torch.zeros(max_batch + 1, dtype=torch.int64, device=coords.device)
    counts.scatter_add_(0, b.clamp(0, max_batch), torch.ones_like(b))
    counts = counts[:max_batch]
    starts = torch.cumsum(counts, 0) - counts
    return starts, counts
