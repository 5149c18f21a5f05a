"""Grid-extent voxel quantization (the default tail of
``imfnet_tpu.sparse.grid.quantize_grid``).

The JAX package also builds its kernel maps from a bit-packed occupancy grid
(``build_pyramid_grid``); those tables equal the exact search builder's, so
the port has one builder (``sparse.kernel_map.build_pyramid``) and keeps from
this module only the extent spec and the quantizer.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from imfnet_tpu_torch.sparse.coords import PAD_COORD, SparseVoxels, compact_first


class GridSpec(NamedTuple):
    """Static grid extents in stride-1 voxel cells."""

    extent: Tuple[int, int, int] = (256, 256, 256)
    num_batches: int = 2


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


def quantize_grid(
    xyz: torch.Tensor,
    feats: torch.Tensor,
    valid: torch.Tensor,
    voxel_size: float,
    n_out: int,
    spec: GridSpec,
    batch_index: torch.Tensor | int = 0,
):
    """Voxelize raw points: ``floor(xyz / voxel)`` per batch, first occurrence
    (minimum original row) wins, rows out in scan order (lexicographic
    (batch, x, y, z)). Points outside the per-batch extent are dropped; on
    overflow the first ``n_out`` voxels in scan order are kept.

    A stable sort on the cell key makes the first row of each equal-key run
    the minimum original row; run starts mark unique cells and are compacted
    in sorted order, which is scan order.

    Returns (SparseVoxels, sel int64[n_out] (-1 in padding), xyz_down[n_out,3]).
    """
    X, Y, Z = spec.extent
    B = spec.num_batches
    n = xyz.shape[0]
    v = torch.floor(xyz / voxel_size).to(torch.int32)
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
    big = torch.iinfo(torch.int64).max
    key = ((bb * X + c[:, 0]) * Y + c[:, 1]) * Z + c[:, 2]
    key = torch.where(in_range, key, torch.full_like(key, big))
    sk, order = torch.sort(key, stable=True)
    prev = torch.cat([sk.new_full((1,), -1), sk[:-1]])
    first = (sk != big) & (sk != prev)
    sel, n_uniq = compact_first(first, order, n_out)
    ok = sel >= 0
    ss = sel.clamp_min(0)
    uniq = torch.where(ok[:, None], coords4[ss],
                       torch.full_like(coords4[:1], PAD_COORD))
    f = torch.where(ok[:, None], feats[ss], torch.zeros_like(feats[:1]))
    xyz_down = torch.where(ok[:, None], xyz[ss], torch.zeros_like(xyz[:1]))
    return SparseVoxels(uniq, f, n_uniq), sel, xyz_down
