"""Host-side sample container, voxel dedup and batch collation (numpy) into
the padded training batch (``imfnet_tpu.data.collate``, the reference's
`collate_pair_fn`, `lib/data_loaders.py:28-91`): batch indices in the coords
column, the pairs of a batch concatenated per side, static padding."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from imfnet_tpu_torch.sparse.coords import PAD_COORD
from imfnet_tpu_torch.train.step import PairBatch
from imfnet_tpu_torch.utils.device import resolve_device
from imfnet_tpu_torch.utils.native import voxel_dedup


@dataclass
class VoxelizedPair:
    """One fragment pair: voxel coords, representative points, images and
    the ground-truth pose (xyz1 ≈ T_gt @ xyz0)."""

    coords0: np.ndarray  # int32[n0,3] voxel coords (floor(xyz/voxel))
    xyz0: np.ndarray     # float32[n0,3] representative points
    feats0: np.ndarray   # float32[n0,1]
    coords1: np.ndarray
    xyz1: np.ndarray
    feats1: np.ndarray
    image0: np.ndarray   # float32[H,W,3]
    image1: np.ndarray
    T_gt: np.ndarray     # float32[4,4]
    # positive-search radius of this sample (the reference scales it with the
    # sample's random scale, `lib/data_loaders.py:273-276`); 0 → the config's
    search_radius: float = 0.0


def voxelize_np(xyz: np.ndarray, voxel_size: float):
    """First-occurrence voxel dedup: (coords int32[k,3], sel int32[k]) with
    rows in order of first occurrence (`ME.utils.sparse_quantize`
    semantics, `lib/data_loaders.py:290-295`): the native hash dedup
    (``utils.native.voxel_dedup``, cells ``floor(xyz * (1/voxel))`` in f32),
    or its numpy fallback where the library did not build."""
    return voxel_dedup(xyz, voxel_size)


def _pack_side(coords_list, xyz_list, feats_list, n_pad: int):
    """One side of a batch: rows of every sample with their batch index,
    sorted by (batch, x, y, z) and padded to ``n_pad``."""
    coords = np.concatenate([
        np.concatenate([np.full((len(c), 1), b, np.int32), c.astype(np.int32)], 1)
        for b, c in enumerate(coords_list)])
    xyz = np.concatenate(xyz_list)
    feats = np.concatenate(feats_list)
    n = len(coords)
    if n > n_pad:
        raise ValueError(f"batch has {n} voxels > capacity {n_pad}; "
                         f"raise config.max_points or reduce batch size")
    order = np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1], coords[:, 0]))
    cp = np.full((n_pad, 4), int(PAD_COORD), np.int32)
    cp[:n] = coords[order]
    xp = np.zeros((n_pad, 3), np.float32)
    xp[:n] = xyz[order]
    fp = np.zeros((n_pad, feats.shape[1]), np.float32)
    fp[:n] = feats[order]
    return cp, xp, fp, n


def collate_pairs(samples: List[VoxelizedPair], n_pad: int, grid_extent=None,
                  device=None) -> PairBatch:
    """A list of voxelized pairs as one padded batch on ``device`` (the card
    by default). Positive correspondences are found on the device
    (``train.step.compute_correspondences``), so none are carried.

    With ``grid_extent`` (the static extent of a grid pyramid) a sample
    whose voxel span exceeds it raises, rather than being cropped by the
    grid."""
    dev = resolve_device(device)
    if grid_extent is not None:
        ext = np.asarray(grid_extent)
        for s in samples:
            for side, c in (("0", s.coords0), ("1", s.coords1)):
                span = c.max(0) - c.min(0) + 1
                if (span > ext).any():
                    raise RuntimeError(
                        f"sample side {side} spans {tuple(span)} voxels > "
                        f"grid_extent {tuple(ext)}; points would be dropped")
    c0, x0, f0, n0 = _pack_side([s.coords0 for s in samples], [s.xyz0 for s in samples],
                                [s.feats0 for s in samples], n_pad)
    c1, x1, f1, n1 = _pack_side([s.coords1 for s in samples], [s.xyz1 for s in samples],
                                [s.feats1 for s in samples], n_pad)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    return PairBatch(
        coords0=t(c0), feats0=t(f0), n0=t(n0, torch.int32),
        image0=t(np.stack([s.image0 for s in samples])),
        coords1=t(c1), feats1=t(f1), n1=t(n1, torch.int32),
        image1=t(np.stack([s.image1 for s in samples])),
        pairs=None, pair_valid=None, xyz0=t(x0), xyz1=t(x1),
        T_gt=t(np.stack([s.T_gt for s in samples]).astype(np.float32)),
        search_radius=t(np.array([s.search_radius for s in samples], np.float32)))
