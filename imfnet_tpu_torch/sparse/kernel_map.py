"""Kernel-map construction: per-kernel-offset neighbour tables.

A kernel map is a dense int32 table ``nbr[N_out, K]`` holding, for each output
row and kernel offset, the input row or -1. Offsets enumerate in
``itertools.product`` order (dx slowest, dz fastest), radius
``kernel_size // 2``, scaled by the level's tensor stride.

This module holds the search builder (``imfnet_tpu.sparse.kernel_map
.build_pyramid``): each level's table is the sorted unique set of strided
coordinates, and each map is a sort-free ``torch.searchsorted`` of the offset
keys into the sorted source table. It needs no grid extent and is the
default of ``train.step.make_pyramid_fn``. The packed-grid builder
(``sparse.grid.build_pyramid_grid``) gives the same tables for in-extent
inputs.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from imfnet_tpu_torch.sparse.coords import lookup, make_keys, row_mask, stride_coords


def kernel_offsets(kernel_size: int, dilation: int = 1) -> np.ndarray:
    """int32[K,3] centered offsets in product order, scaled by dilation."""
    r = kernel_size // 2
    offs = np.array(
        list(itertools.product(range(-r, r + 1), repeat=3)), dtype=np.int32
    )
    return offs * dilation


def offsets_on(kernel_size: int, scale: int, device) -> torch.Tensor:
    """int32[K,3]: ``kernel_offsets(kernel_size) * scale`` made on
    ``device`` itself, with no copy from the host, which a CUDA graph
    cannot hold."""
    r = kernel_size // 2
    g = torch.arange(-r, r + 1, dtype=torch.int32, device=device) * scale
    return torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(-1, 3)


def offset_map(out_coords: torch.Tensor, out_valid: torch.Tensor,
               in_coords: torch.Tensor, in_valid: torch.Tensor,
               offsets) -> torch.Tensor:
    """nbr[N_out, K]: the row of ``out + offset`` in the input table, or -1.
    The input table's valid rows must be sorted by key. ``offsets`` is an
    int[K,3] array, or a tensor on the coordinates' device."""
    table = make_keys(in_coords, in_valid, is_table=True)
    offs = torch.zeros((len(offsets), 4), dtype=torch.int32,
                       device=out_coords.device)
    offs[:, 1:] = torch.as_tensor(offsets, dtype=torch.int32,
                                  device=out_coords.device)
    q = (out_coords[:, None, :] + offs[None]).reshape(-1, 4)
    qv = out_valid[:, None].expand(-1, len(offsets)).reshape(-1)
    keys = make_keys(q, qv, is_table=False)
    return lookup(table, keys).reshape(out_coords.shape[0], len(offsets))


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

    coords: torch.Tensor            # int32[N,4] sorted table at this level
    num_valid: torch.Tensor         # int32[]
    k3_same: torch.Tensor           # [N,27] stride-1 k3 map at this level
    down: Optional[torch.Tensor]    # [N,27] gathers from the finer level
    up: Optional[torch.Tensor]      # [N,27] gathers from the coarser level


class CoordinatePyramid(NamedTuple):
    """Coordinate tables and kernel maps for every UNet level; levels[i] is
    tensor stride 2**i."""

    levels: Tuple[LevelMaps, ...]
    k5_l0: torch.Tensor  # [N0, conv1_kernel_size**3] conv1 kernel map


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
    """The full UNet coordinate structure (4 levels, strides 1/2/4/8).

    ``level_capacity[i]`` is the padded row count of level i; a level keeps
    the first ``capacity`` unique coordinates in scan order."""
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
    valid = [row_mask(c.shape[0], n) for c, n in tables]
    dev = coords.device

    levels = []
    for i in range(num_levels):
        c, n = tables[i]
        t = 2 ** i
        same = offset_map(c, valid[i], c, valid[i], offsets_on(3, t, dev))
        down = None
        if i > 0:
            down = offset_map(c, valid[i], tables[i - 1][0], valid[i - 1],
                              offsets_on(3, 2 ** (i - 1), dev))
        up = None
        if i < num_levels - 1:
            up = offset_map(c, valid[i], tables[i + 1][0], valid[i + 1], offsets_on(3, t, dev))
        levels.append(LevelMaps(c, n, same, down, up))

    c0 = tables[0][0]
    k5 = offset_map(c0, valid[0], c0, valid[0], offsets_on(conv1_kernel_size, 1, dev))
    return CoordinatePyramid(tuple(levels), k5)
