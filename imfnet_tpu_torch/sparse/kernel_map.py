"""Kernel-map construction: per-kernel-offset neighbour tables.

A kernel map is a dense int32 table ``nbr[N_out, K]`` holding, for each output
row and kernel offset, the input row or -1. Offsets enumerate in
``itertools.product`` order (dx slowest, dz fastest), radius
``kernel_size // 2``, scaled by the level's tensor stride. The dimension D
(3, or 6 for ``eval.dgr``'s correspondence tensors) is the coordinates'
(``coords.coord_dim``): a 3-D k3 conv has 27 offsets, a 6-D one 3^6 = 729.

This module holds the search builder (``imfnet_tpu.sparse.kernel_map
.build_pyramid``): each level's table is the sorted unique set of strided
coordinates. A 3-D map is a sort-free ``torch.searchsorted`` of the offset
keys into the sorted source table (``coords.lookup``). A 6-D map comes, on
the card, from kernel E (``sparse.map6_kernel.map6_many``: one hash a level
table, every map of a pyramid written in one launch); its plain version,
for CPU tensors and the tests' oracle, is ``offset_map6_plain``, the same
search in chunks of offsets. The builder needs no grid extent and is the
default of ``train.step.make_pyramid_fn``. The port's one other builder,
the grid builder (``sparse.grid.build_pyramid_grid``, kernel D), gives the
same tables for in-extent 3-D inputs; 6-D pyramids are built here alone.
"""
from __future__ import annotations

import itertools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from imfnet_tpu_torch.sparse.coords import (KEY6_BITS, KEY6_MARGIN, PAD_QUERY_KEY,
                                            coord_dim, lookup, make_keys, row_mask,
                                            stride_coords)
from imfnet_tpu_torch.sparse.map6_kernel import map6_many

# query keys one chunk of a 6-D map holds at most (int64 each; the chunk's
# temporaries are a few such tensors: about 40 bytes an entry, 0.7 GB)
MAP_CHUNK_ENTRIES = 1 << 24


def kernel_offsets(kernel_size: int, dilation: int = 1) -> np.ndarray:
    """int32[K,3] centered offsets in product order, scaled by dilation."""
    r = kernel_size // 2
    offs = np.array(
        list(itertools.product(range(-r, r + 1), repeat=3)), dtype=np.int32
    )
    return offs * dilation


def offsets_on(kernel_size: int, scale: int, device, dim: int = 3) -> torch.Tensor:
    """int32[K,dim]: the ``dim``-D ``kernel_offsets(kernel_size) * scale`` made
    on ``device`` itself, with no copy from the host, which a CUDA graph
    cannot hold."""
    r = kernel_size // 2
    g = torch.arange(-r, r + 1, dtype=torch.int32, device=device) * scale
    return torch.stack(torch.meshgrid(*[g] * dim, indexing="ij"), dim=-1).reshape(-1, dim)


def offset_map(out_coords: torch.Tensor, out_valid: torch.Tensor,
               in_coords: torch.Tensor, in_valid: torch.Tensor,
               offsets) -> torch.Tensor:
    """nbr[N_out, K]: the row of ``out + offset`` in the input table, or -1.
    The input table's valid rows must be sorted by key. ``offsets`` is an
    int[K,D] array, or a tensor on the coordinates' device. 6-D maps go to
    ``offset_map6``."""
    if coord_dim(out_coords) == 6:
        return offset_map6(out_coords, out_valid, in_coords, in_valid,
                           torch.as_tensor(offsets, dtype=torch.int32,
                                           device=out_coords.device))
    table = make_keys(in_coords, in_valid, is_table=True)
    offs = torch.zeros((len(offsets), 4), dtype=torch.int32,
                       device=out_coords.device)
    offs[:, 1:] = torch.as_tensor(offsets, dtype=torch.int32,
                                  device=out_coords.device)
    q = (out_coords[:, None, :] + offs[None]).reshape(-1, 4)
    qv = out_valid[:, None].expand(-1, len(offsets)).reshape(-1)
    keys = make_keys(q, qv, is_table=False)
    return lookup(table, keys).reshape(out_coords.shape[0], len(offsets))


def key_deltas(offsets: torch.Tensor) -> torch.Tensor:
    """int64[K]: each 6-D offset's key delta, ``Σ_a o_a << 10 (5 - a)``. An
    offset of at most ``KEY6_MARGIN`` a axis moves an in-range row's key
    fields without a borrow or carry (``coords.in_key_range``), so a
    query's key is its row's key plus its offset's delta; a delta scales
    with its offset."""
    o = offsets.to(torch.int64)
    delta = o[:, 0]
    for a in range(1, 6):
        delta = (delta << KEY6_BITS) + o[:, a]
    return delta


def offset_map6(out_coords: torch.Tensor, out_valid: torch.Tensor,
                in_coords: torch.Tensor, in_valid: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """``offset_map`` of 6-D coordinates: ``offset_maps6`` for one map."""
    return offset_maps6([(out_coords, out_valid), (in_coords, in_valid)],
                        [(0, 1, offsets, 1)])[0]


# (out table, in table, offsets int32[K, 6], scale): the map of the offsets
# times scale, from the out table's rows into the in table
Map6 = Tuple[int, int, torch.Tensor, int]


def offset_maps6(tables: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 problems: Sequence[Map6]) -> List[torch.Tensor]:
    """The 6-D map of each ``(out, in, offsets, scale)`` over ``tables``
    (coords, valid): nbr[N_out, K], the row of ``out + scale * offset`` in
    the in table, or -1. Each table's valid rows must be sorted by key. On
    the card kernel E builds them all in one call (``map6_many``: each
    searched table hashed once); CPU tensors take ``offset_map6_plain`` a
    map. The scaled offsets must stay within ``KEY6_MARGIN`` a axis."""
    if tables[0][0].device.type == "cpu":
        return [offset_map6_plain(*tables[o], *tables[i], offs * scale)
                for o, i, offs, scale in problems]
    keys = [make_keys(c, v, is_table=True) for c, v in tables]
    deltas = {}
    for _, _, offs, _ in problems:
        if id(offs) not in deltas:
            deltas[id(offs)] = key_deltas(offs)
    return map6_many(keys, [(o, i, deltas[id(offs)], scale) for o, i, offs, scale in problems])


def offset_map6_plain(out_coords: torch.Tensor, out_valid: torch.Tensor,
                      in_coords: torch.Tensor, in_valid: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """Kernel E's plain version, a 6-D map by search in chunks of offsets:
    each query key, its row's key plus its offset's (``key_deltas``), is
    ``torch.searchsorted`` in the sorted table (``coords.lookup``); a row
    out of range or invalid keeps ``PAD_QUERY_KEY`` and misses. At most
    ``MAP_CHUNK_ENTRIES`` query keys are held at a time: the temporaries
    are about 40 bytes a chunk entry (the int64 keys, the search's int64
    positions, masks), 0.7 GB at most, whatever K (729 at a k3 conv) and
    N_out. The offsets must stay within ``KEY6_MARGIN`` a axis
    (``build_pyramid`` checks its levels' strides)."""
    n_out, k = out_coords.shape[0], offsets.shape[0]
    table = make_keys(in_coords, in_valid, is_table=True)
    rows = make_keys(out_coords, out_valid, is_table=False)[:, None]
    miss = rows == PAD_QUERY_KEY
    delta = key_deltas(offsets)
    nbr = torch.empty((n_out, k), dtype=torch.int32, device=out_coords.device)
    chunk = max(1, min(k, MAP_CHUNK_ENTRIES // max(n_out, 1)))
    for k0 in range(0, k, chunk):
        key = torch.where(miss, rows, rows + delta[None, k0:k0 + chunk])
        nbr[:, k0:k0 + chunk] = lookup(table, key)
    return nbr


def kernel_map_same(coords: torch.Tensor, valid: torch.Tensor, kernel_size: int,
                    tensor_stride: int) -> torch.Tensor:
    """Map for a stride-1 conv: outputs are the inputs, offsets in units of
    the tensor stride (`MinkowskiConvolution(kernel_size=k, stride=1)`)."""
    return offset_map(coords, valid, coords, valid,
                      offsets_on(kernel_size, tensor_stride, coords.device))


def kernel_map_down(in_coords: torch.Tensor, in_valid: torch.Tensor,
                    out_coords: torch.Tensor, out_valid: torch.Tensor, kernel_size: int,
                    in_tensor_stride: int) -> torch.Tensor:
    """Map for a stride-2 downsampling conv (t → 2t): each output coordinate
    (a multiple of 2t) gathers the inputs at out + δ·t, δ centered."""
    return offset_map(out_coords, out_valid, in_coords, in_valid,
                      offsets_on(kernel_size, in_tensor_stride, out_coords.device))


def kernel_map_up(in_coords: torch.Tensor, in_valid: torch.Tensor,
                  out_coords: torch.Tensor, out_valid: torch.Tensor, kernel_size: int,
                  out_tensor_stride: int) -> torch.Tensor:
    """Map for a stride-2 transpose conv (2t → t): the outputs are the
    cached finer level's coordinates, each gathering the inputs among
    out + δ·t that exist at stride 2t (`MinkowskiConvolutionTranspose`,
    `model/resunet.py:101-139`)."""
    return offset_map(out_coords, out_valid, in_coords, in_valid,
                      offsets_on(kernel_size, out_tensor_stride, out_coords.device))


class LevelMaps(NamedTuple):
    """Kernel maps and coordinate metadata for one UNet resolution level."""

    coords: torch.Tensor            # int32[N,1+D] sorted table at this level
    num_valid: torch.Tensor         # int32[]
    k3_same: torch.Tensor           # [N,3^D] stride-1 k3 map at this level
    down: Optional[torch.Tensor]    # [N,3^D] gathers from the finer level
    up: Optional[torch.Tensor]      # [N,3^D] gathers from the coarser level


class CoordinatePyramid(NamedTuple):
    """Coordinate tables and kernel maps for every UNet level; levels[i] is
    tensor stride 2**i."""

    levels: Tuple[LevelMaps, ...]
    k5_l0: torch.Tensor  # [N0, conv1_kernel_size**D] conv1 kernel map


def coarse_levels_fit(pyr: CoordinatePyramid) -> torch.Tensor:
    """bool[]: every coarser level's unique count sits strictly below its
    capacity. A full level cannot be told from an overflowed one, so
    ``num_valid >= capacity`` counts as overflow."""
    ok = torch.ones((), dtype=torch.bool, device=pyr.k5_l0.device)
    for lv in pyr.levels[1:]:
        ok = ok & (lv.num_valid < lv.coords.shape[0])
    return ok


def build_pyramid(
    coords: torch.Tensor,
    num_valid: torch.Tensor,
    *,
    num_levels: int = 4,
    conv1_kernel_size: int = 5,
    level_capacity: Tuple[int, ...] | None = None,
) -> CoordinatePyramid:
    """The full UNet coordinate structure (4 levels, strides 1/2/4/8), in
    the coordinates' dimension (3 or 6; every axis strided).

    ``level_capacity[i]`` is the padded row count of level i; a level keeps
    the first ``capacity`` unique coordinates in scan order. A 6-D pyramid
    whose conv1 is k3 shares level 0's k3 map as conv1's."""
    n0 = coords.shape[0]
    if level_capacity is None:
        level_capacity = tuple(max(256, n0 >> i) for i in range(num_levels))
    if level_capacity[0] < n0:
        raise ValueError("level 0 capacity must hold the input")

    tables = [(coords, num_valid)]
    for i in range(1, num_levels):
        prev_coords, prev_n = tables[-1]
        prev_valid = row_mask(prev_coords.shape[0], prev_n)
        tables.append(stride_coords(prev_coords, prev_valid, 2 ** i,
                                    level_capacity[i]))
    dim = coord_dim(coords)
    if dim == 6 and 2 ** (num_levels - 1) > KEY6_MARGIN:
        raise ValueError(f"build_pyramid: a 6-D pyramid's offsets stay within "
                         f"{KEY6_MARGIN} a axis: at most 4 levels, got {num_levels}")
    valid = [row_mask(c.shape[0], n) for c, n in tables]
    dev = coords.device

    def offs(k, s):
        return offsets_on(k, s, dev, dim)

    if dim == 6:
        return _pyramid6(tables, valid, conv1_kernel_size, offs(3, 1))

    levels = []
    for i in range(num_levels):
        c, n = tables[i]
        t = 2 ** i
        same = offset_map(c, valid[i], c, valid[i], offs(3, t))
        down = None
        if i > 0:
            down = offset_map(c, valid[i], tables[i - 1][0], valid[i - 1],
                              offs(3, 2 ** (i - 1)))
        up = None
        if i < num_levels - 1:
            up = offset_map(c, valid[i], tables[i + 1][0], valid[i + 1], offs(3, t))
        levels.append(LevelMaps(c, n, same, down, up))

    c0 = tables[0][0]
    k5 = offset_map(c0, valid[0], c0, valid[0], offs(conv1_kernel_size, 1))
    return CoordinatePyramid(tuple(levels), k5)


def _pyramid6(tables, valid, conv1_kernel_size: int, unit: torch.Tensor) -> CoordinatePyramid:
    """A 6-D pyramid's maps in one ``offset_maps6`` call: each level's same
    map, down map (from the finer level, offsets at half its stride) and up
    map (from the coarser), all at the k3 offsets ``unit`` times a stride;
    conv1 k3 shares level 0's map, another conv1 adds its own."""
    n = len(tables)
    problems, at = [], {}
    for i in range(n):
        for name, src, scale in (("same", i, 2 ** i), ("down", i - 1, 2 ** i // 2),
                                 ("up", i + 1, 2 ** i)):
            if 0 <= src < n:
                at[name, i] = len(problems)
                problems.append((i, src, unit, scale))
    if conv1_kernel_size != 3:
        at["conv1", 0] = len(problems)
        problems.append((0, 0, offsets_on(conv1_kernel_size, 1, unit.device, 6), 1))
    maps = offset_maps6([(c, v) for (c, _), v in zip(tables, valid)], problems)

    def get(name, i):
        return maps[at[name, i]] if (name, i) in at else None

    levels = tuple(LevelMaps(c, num, get("same", i), get("down", i), get("up", i))
                   for i, (c, num) in enumerate(tables))
    return CoordinatePyramid(levels, get("conv1", 0) if conv1_kernel_size != 3
                             else levels[0].k3_same)
