"""Synthetic fragment pairs and training batches (numpy): the same arrays
as ``imfnet_tpu.data.synthetic`` for the same RandomState."""
from __future__ import annotations

import numpy as np

from imfnet_tpu_torch.data.collate import VoxelizedPair, collate_pairs, voxelize_np
from imfnet_tpu_torch.geom.transforms import axis_angle_rotation


def _surface_cloud(rng: np.random.RandomState, n: int, extent: float) -> np.ndarray:
    """Points scattered on a few random planar patches + a sphere shell."""
    parts = []
    n_planes = 4
    for _ in range(n_planes):
        k = n // (n_planes + 1)
        normal = rng.randn(3)
        normal /= np.linalg.norm(normal)
        u = np.cross(normal, [1.0, 0.3, 0.2])
        u /= np.linalg.norm(u)
        v = np.cross(normal, u)
        origin = (rng.rand(3) - 0.5) * extent
        ab = (rng.rand(k, 2) - 0.5) * extent
        parts.append(origin + ab[:, :1] * u + ab[:, 1:] * v)
    k = n - sum(len(p) for p in parts)
    d = rng.randn(k, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    parts.append(d * extent * 0.4)
    pts = np.concatenate(parts).astype(np.float32)
    return pts + rng.randn(len(pts), 3).astype(np.float32) * 0.003


def synthetic_pair(
    rng: np.random.RandomState,
    n_points: int = 8000,
    voxel_size: float = 0.025,
    extent: float = 1.5,
    image_hw=(120, 160),
    overlap: float = 0.7,
) -> VoxelizedPair:
    """Two overlapping surface-like clouds with a known rigid transform."""
    base = _surface_cloud(rng, n_points, extent)
    axis = rng.randn(3)
    keep0 = rng.rand(len(base)) < (overlap + (1 - overlap) / 2)
    keep1 = rng.rand(len(base)) < (overlap + (1 - overlap) / 2)
    xyz0 = base[keep0]
    xyz1_src = base[keep1]
    R = axis_angle_rotation(axis, rng.rand() * np.pi)
    t = rng.randn(3) * 0.5
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    xyz1 = (xyz1_src @ R.T + t).astype(np.float32)

    c0, sel0 = voxelize_np(xyz0, voxel_size)
    c1, sel1 = voxelize_np(xyz1, voxel_size)
    h, w = image_hw
    return VoxelizedPair(
        coords0=c0, xyz0=xyz0[sel0].astype(np.float32),
        feats0=np.ones((len(c0), 1), np.float32),
        coords1=c1, xyz1=xyz1[sel1].astype(np.float32),
        feats1=np.ones((len(c1), 1), np.float32),
        image0=rng.rand(h, w, 3).astype(np.float32),
        image1=rng.rand(h, w, 3).astype(np.float32),
        T_gt=T,
    )


def synthetic_batch(
    rng: np.random.RandomState,
    batch_size: int = 2,
    n_points: int = 8000,
    n_pad: int = 16384,
    voxel_size: float = 0.025,
    image_hw=(120, 160),
    device=None,
):
    """``batch_size`` synthetic pairs collated into one padded training
    batch on ``device`` (the card by default)."""
    samples = [synthetic_pair(rng, n_points, voxel_size, image_hw=image_hw)
               for _ in range(batch_size)]
    return collate_pairs(samples, n_pad, device=device)
