"""Outdoor scan pairs from the seed (numpy), in the layout of a KITTI
odometry pair.

A world of a ground plane, building walls, parked cars (boxes) and poles
is sampled densely once a pair; a scan keeps ``points`` of the world's
points within ``radius_m`` of its sensor, in the sensor's frame, with
``noise_m`` of noise. The second sensor stands ``baseline_m`` away with a
yaw of up to ``yaw_deg``, as KITTI's test pairs lie at least 10 m apart.
Each scan is voxelized here at ``voxel_size`` (``floor(xyz / voxel)``,
first point of a voxel kept), so the program and the reference get the
same voxels. ``T_gt`` maps scan 0's frame into scan 1's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from traffic.surface import rng_for


def _world(rng: np.random.Generator, n: int, half: float) -> np.ndarray:
    parts = []
    k = n // 2
    g = rng.uniform(-half, half, (k, 2))
    parts.append(np.c_[g, rng.normal(0.0, 0.02, k)])                    # ground
    for _ in range(24):                                                 # walls
        c = rng.uniform(-half, half, 2)
        ang = rng.uniform(0, np.pi)
        length, height = rng.uniform(8, 30), rng.uniform(3, 12)
        m = n // 80
        s, h = rng.uniform(-0.5, 0.5, m) * length, rng.uniform(0, height, m)
        parts.append(np.c_[c[0] + s * np.cos(ang), c[1] + s * np.sin(ang), h])
    for _ in range(40):                                                 # cars
        c = rng.uniform(-half, half, 2)
        size = np.array([4.2, 1.8, 1.5])
        m = n // 400
        parts.append(np.r_[c, 0.0] + (rng.random((m, 3)) - [0.5, 0.5, 0.0]) * size)
    for _ in range(60):                                                 # poles
        c = rng.uniform(-half, half, 2)
        m = n // 1500
        a = rng.uniform(0, 2 * np.pi, m)
        parts.append(np.c_[c[0] + 0.15 * np.cos(a), c[1] + 0.15 * np.sin(a),
                           rng.uniform(0, 6, m)])
    return np.concatenate(parts)


def _pose(x: float, y: float, yaw: float) -> np.ndarray:
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:2, 3] = [x, y]
    return T


def _scan(rng, world: np.ndarray, pose: np.ndarray, p: Dict) -> np.ndarray:
    local = (world - pose[:3, 3]) @ pose[:3, :3]                     # world → sensor
    near = local[np.linalg.norm(local[:, :2], axis=1) < p["radius_m"]]
    pick = rng.choice(len(near), size=min(p["points"], len(near)), replace=False)
    pts = near[pick] + rng.normal(0.0, p["noise_m"], (len(pick), 3))
    return pts.astype(np.float32)


def voxelize(xyz: np.ndarray, voxel_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """(coords int32[k, 3], xyz[k, 3]): each voxel's cell and its first
    point, voxels in order of first occurrence."""
    v = np.floor(xyz / np.float32(voxel_size)).astype(np.int64)
    lo = v.min(0)
    key = ((v[:, 0] - lo[0]) << 42) | ((v[:, 1] - lo[1]) << 21) | (v[:, 2] - lo[2])
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)
    return v[first].astype(np.int32), xyz[first]


def pair(rng: np.random.Generator, p: Dict) -> Dict:
    world = _world(rng, p["world_points"], p["radius_m"] + p["baseline_m"][1] + 10.0)
    yaw0 = rng.uniform(0, 2 * np.pi)
    P0 = _pose(0.0, 0.0, yaw0)
    d = rng.uniform(*p["baseline_m"])
    heading = yaw0 + rng.uniform(-0.2, 0.2)
    P1 = _pose(d * np.cos(heading), d * np.sin(heading),
               yaw0 + np.radians(rng.uniform(-p["yaw_deg"], p["yaw_deg"])))
    s0, s1 = _scan(rng, world, P0, p), _scan(rng, world, P1, p)
    c0, x0 = voxelize(s0, p["voxel_size"])
    c1, x1 = voxelize(s1, p["voxel_size"])
    h, w = p["image_hw"]
    return {"coords0": c0, "xyz0": x0, "coords1": c1, "xyz1": x1,
            "image0": rng.random((h, w, 3), dtype=np.float32),
            "image1": rng.random((h, w, 3), dtype=np.float32),
            # scan 0's frame into scan 1's
            "T_gt": (np.linalg.inv(P1) @ P0).astype(np.float32)}


def pool(seed: int, p: Dict) -> List[Dict]:
    return [pair(rng_for(seed, i), p) for i in range(p["pool"])]
