"""Host-side sample container and voxel dedup (numpy)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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


def voxelize_np(xyz: np.ndarray, voxel_size: float):
    """First-occurrence voxel dedup: (coords int32[k,3], sel int32[k]) with
    rows in order of first occurrence (`ME.utils.sparse_quantize`
    semantics). Cells are ``floor(xyz * (1/voxel))`` in float32, the
    arithmetic of the reference's native dedup (native/host_ops.cpp)."""
    inv = np.float32(1.0) / np.float32(voxel_size)
    v = np.floor(np.asarray(xyz, np.float32) * inv).astype(np.int32)
    if len(v) == 0:
        return v.reshape(0, 3), np.zeros((0,), np.int32)
    _, sel = np.unique(v, axis=0, return_index=True)
    sel = np.sort(sel)
    return v[sel], sel.astype(np.int32)
