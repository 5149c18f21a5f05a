"""Descriptors for Deep Global Registration's scan pairs (numpy).

The scans are ``traffic/kitti.py``'s pairs. Each voxel of both scans gets a
32-d unit descriptor drawn from the seed, independent of every other. Each
pair then draws an inlier share from ``inlier_share``; of the source voxels
whose point lies within ``match_m`` of a target voxel's point under
``T_gt``, that share (a random subset) hands its descriptor to that target
voxel: the target's descriptor becomes the source's plus normal noise of
``noise`` a component, renormalized. A target voxel taken twice keeps the
last. So the nearest target descriptor of a source voxel is its true match
at about the drawn rate, as trained descriptors would make it, and every
other correspondence is a random voxel of the target scan.

``realized_share`` counts, over a pair's source voxels, those whose nearest
target descriptor is a voxel within ``match_m`` of their true position:
the share of correspondences that are inliers.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.spatial import cKDTree

from traffic import kitti
from traffic.surface import rng_for


def _unit(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    f = rng.standard_normal((n, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def true_matches(q: Dict, match_m: float) -> np.ndarray:
    """int64[n0]: each source voxel's nearest target voxel under ``T_gt``,
    -1 where none lies within ``match_m``."""
    T = q["T_gt"].astype(np.float64)
    moved = q["xyz0"].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    d, j = cKDTree(q["xyz1"].astype(np.float64)).query(moved, k=1)
    return np.where(d <= match_m, j, -1).astype(np.int64)


def descriptors(rng: np.random.Generator, q: Dict, p: Dict) -> Dict:
    n0, n1, d = len(q["xyz0"]), len(q["xyz1"]), int(p["dim"])
    f0, f1 = _unit(rng, n0, d), _unit(rng, n1, d)
    share = float(rng.uniform(*p["inlier_share"]))
    match = true_matches(q, float(p["match_m"]))
    has = np.flatnonzero(match >= 0)
    take = rng.permutation(has)[:int(round(share * len(has)))]
    noisy = f0[take] + rng.normal(0.0, float(p["noise"]), (len(take), d)).astype(np.float32)
    f1[match[take]] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    return {"feats0": f0, "feats1": f1, "share": share}


def pair(seed: int, i: int, p: Dict) -> Dict:
    q = kitti.pair(rng_for(seed, i), p)
    q.update(descriptors(rng_for(seed, i, 1 << 23), q, p))
    return q


def pool(seed: int, p: Dict) -> List[Dict]:
    return [pair(seed, i, p) for i in range(p["pool"])]


def realized_share(q: Dict, nn: np.ndarray, match_m: float) -> float:
    """The share of source voxels whose correspondence (``nn``: the index
    of its nearest target descriptor) lies within ``match_m`` of its true
    position."""
    T = q["T_gt"].astype(np.float64)
    moved = q["xyz0"].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    d = np.linalg.norm(moved - q["xyz1"][nn].astype(np.float64), axis=1)
    return float((d <= match_m).mean())
