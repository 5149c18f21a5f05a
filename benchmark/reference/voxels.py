"""Voxel tables and kernel maps, plain PyTorch.

A table is the sorted set of a cloud's voxels, ``coords int64[N, 4]`` =
(batch, x, y, z), lexicographic. A voxel keeps its first raw point
(`ME.utils.sparse_quantize`, first occurrence). The pyramid's level i holds
the unique ``floor(c / 2^i) * 2^i`` of level 0; a map ``nbr[N_out, K]``
holds, for each output voxel and kernel offset (dx slowest, dz fastest,
`MinkowskiEngine`'s kernel region), the input row or -1.
"""
from __future__ import annotations

import itertools
from typing import List, NamedTuple, Optional, Tuple

import torch

_SHIFT = 1 << 15


def keys(coords: torch.Tensor) -> torch.Tensor:
    """int64 key per voxel that orders as (batch, x, y, z) does."""
    c = coords.to(torch.int64)
    return (((c[:, 0] << 16 | (c[:, 1] + _SHIFT)) << 16 | (c[:, 2] + _SHIFT)) << 16
            | (c[:, 3] + _SHIFT))


def cells(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """int64[N, 3] ``floor(xyz / voxel_size)``, by a true float32 division."""
    v = torch.full((), voxel_size, dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz.float() / v).to(torch.int64)


def voxelize(xyz: torch.Tensor, batch: torch.Tensor, voxel_size: float,
             extent: Optional[Tuple[int, int, int]] = None):
    """(coords int64[N, 4] sorted, first int64[N]: the raw row each voxel
    keeps). With ``extent`` a point whose cell lies at or beyond
    ``extent`` cells from its batch's smallest cell is dropped."""
    v = cells(xyz, voxel_size)
    b = batch.to(torch.int64)
    keep = torch.ones(len(v), dtype=torch.bool, device=v.device)
    if extent is not None:
        ext = torch.tensor(extent, dtype=torch.int64, device=v.device)
        for bi in torch.unique(b).tolist():
            m = b == bi
            lo = v[m].min(dim=0).values
            keep[m] = ((v[m] - lo) < ext).all(dim=1)
    rows = torch.nonzero(keep).squeeze(1)
    c4 = torch.cat([b[rows, None], v[rows]], dim=1)
    k = keys(c4)
    order = torch.argsort(k, stable=True)
    sk = k[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    sel = order[first]
    return c4[sel], rows[sel]


def offsets(kernel_size: int, scale: int, device) -> torch.Tensor:
    r = kernel_size // 2
    offs = torch.tensor(list(itertools.product(range(-r, r + 1), repeat=3)),
                        dtype=torch.int64, device=device)
    return offs * scale


def offset_map(out_coords: torch.Tensor, in_coords: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """nbr int64[N_out, K]: the row of ``out + offset`` among the sorted
    input voxels, or -1."""
    table = keys(in_coords)
    n_out, n_k = len(out_coords), len(offs)
    nbr = torch.full((n_out, n_k), -1, dtype=torch.int64, device=out_coords.device)
    if len(table) == 0:
        return nbr
    for k in range(n_k):
        q = out_coords.clone()
        q[:, 1:] += offs[k]
        qk = keys(q)
        pos = torch.searchsorted(table, qk).clamp_max(len(table) - 1)
        nbr[:, k] = torch.where(table[pos] == qk, pos, torch.full_like(pos, -1))
    return nbr


class Pyramid(NamedTuple):
    tables: List[torch.Tensor]          # level i: coords at tensor stride 2^i
    same: List[torch.Tensor]            # level i: k3 stride-1 map
    down: List[Optional[torch.Tensor]]  # level i: gathers level i-1 (None at 0)
    up: List[Optional[torch.Tensor]]    # level i: gathers level i+1 (None at top)
    conv1: torch.Tensor                 # level 0: conv1's map


def pyramid(coords: torch.Tensor, num_levels: int = 4,
            conv1_kernel_size: int = 5) -> Pyramid:
    dev = coords.device
    tables = [coords]
    for i in range(1, num_levels):
        s = 1 << i
        c = coords.clone()
        c[:, 1:] = torch.div(c[:, 1:], s, rounding_mode="floor") * s
        tables.append(_unique_sorted(c))
    same, down, up = [], [], []
    for i in range(num_levels):
        t = 1 << i
        same.append(offset_map(tables[i], tables[i], offsets(3, t, dev)))
        down.append(None if i == 0 else
                    offset_map(tables[i], tables[i - 1], offsets(3, t >> 1, dev)))
        up.append(None if i == num_levels - 1 else
                  offset_map(tables[i], tables[i + 1], offsets(3, t, dev)))
    conv1 = offset_map(tables[0], tables[0], offsets(conv1_kernel_size, 1, dev))
    return Pyramid(tables, same, down, up, conv1)


def _unique_sorted(c: torch.Tensor) -> torch.Tensor:
    k = keys(c)
    order = torch.argsort(k, stable=True)
    sk = k[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    return c[order[first]]
