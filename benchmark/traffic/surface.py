"""Indoor fragment pairs and fragments from the seed (numpy).

A scene is a frozen copy of the surface generator of the program's
synthetic data (``imfnet_tpu_torch/data/synthetic.py::_surface_cloud``):
``points`` points on four random planar patches and a sphere shell, with
3 mm of noise. A pair is two crops of one scene along a random direction,
each keeping the share ``(1 + overlap) / 2`` of it, so that they share
``overlap`` of it (drawn from the ``overlap`` range); fragment 1 is then
moved by a random rigid motion (any rotation, about 0.5 m of translation).

Sizes do not move with the seed: each entry of ``slots`` fixes a unit's
voxel bucket (voxels a side of the program's 2-batch for a pair, of the
fragment alone for a fragment), and the scene's scale is searched so that
the unit's voxel count falls in that bucket, at ``fill`` of the way from
the bucket below. The seed draws the geometry, the overlap, the motion and
the images. A draw whose coarse pyramid levels would fill the program's
capacities (``capacity_divisors``), or whose span exceeds ``grid_extent``,
is drawn again from the next stream of its slot.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

VOXEL_BUCKETS = (8192, 12288, 16384, 20480, 24576, 28672, 32768)


def rng_for(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *index])


def unit_scene(rng: np.random.Generator, n: int) -> np.ndarray:
    """The surface cloud at extent 1, without noise."""
    parts = []
    n_planes = 4
    for _ in range(n_planes):
        k = n // (n_planes + 1)
        normal = rng.standard_normal(3)
        normal /= np.linalg.norm(normal)
        u = np.cross(normal, [1.0, 0.3, 0.2])
        u /= np.linalg.norm(u)
        v = np.cross(normal, u)
        origin = rng.random(3) - 0.5
        ab = rng.random((k, 2)) - 0.5
        parts.append(origin + ab[:, :1] * u + ab[:, 1:] * v)
    k = n - sum(len(p) for p in parts)
    d = rng.standard_normal((k, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    parts.append(d * 0.4)
    return np.concatenate(parts)


def rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    a = axis / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def cells(xyz: np.ndarray, voxel_size: float, stride: int = 1) -> np.ndarray:
    return np.floor_divide(np.floor(xyz / np.float32(voxel_size)).astype(np.int64), stride)


def voxel_count(xyz: np.ndarray, voxel_size: float, stride: int = 1) -> int:
    v = cells(xyz, voxel_size, stride)
    v -= v.min(0)
    return len(np.unique((v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2]))


def bucket_of(n: int) -> int:
    return next(b for b in VOXEL_BUCKETS if b >= n)


def _fits(frags: List[np.ndarray], n_pad: int, p: Dict) -> bool:
    vs = p["voxel_size"]
    for x in frags:
        v = cells(x, vs)
        if ((v.max(0) - v.min(0) + 1) > np.asarray(p["grid_extent"])).any():
            return False
    return all(sum(voxel_count(x, vs, 1 << i) for x in frags) < max(n_pad // d, 256)
               for i, d in enumerate(p["capacity_divisors"]) if i > 0)


def _scaled(frags, noise, extent):
    return [(f * extent + e).astype(np.float32) for f, e in zip(frags, noise)]


def _sized(frags: List[np.ndarray], noise, bucket: int, sides: int, p: Dict):
    """The fragments scaled so that their voxels together fall in
    (sides * lower bucket, sides * bucket], or None."""
    lo = sides * max([b for b in VOXEL_BUCKETS if b < bucket], default=0)
    hi = sides * bucket
    target = lo + p["fill"] * (hi - lo)
    a, b = 0.2, 6.0
    for _ in range(30):
        e = 0.5 * (a + b)
        n = sum(voxel_count(x, p["voxel_size"]) for x in _scaled(frags, noise, e))
        if lo < n <= hi and abs(n - target) <= 0.1 * (hi - lo):
            out = _scaled(frags, noise, e)
            return out if _fits(out, hi, p) else None
        a, b = (e, b) if n < target else (a, e)
    return None


def _pair_draw(rng: np.random.Generator, p: Dict):
    scene = unit_scene(rng, int(p["points"]))
    overlap = rng.uniform(*p["overlap"])
    share = (1.0 + overlap) / 2.0
    direction = rng.standard_normal(3)
    rank = np.argsort(np.argsort(scene @ (direction / np.linalg.norm(direction))))
    rank = rank / len(scene)
    f0, f1 = scene[rank < share], scene[rank >= 1.0 - share]
    R = rotation(rng.standard_normal(3), rng.uniform(0.0, np.pi))
    f1 = f1 @ R.T
    noise = [rng.standard_normal(f.shape) * 0.003 for f in (f0, f1)]
    return f0, f1, noise, R, overlap


def pair(seed: int, slot: int, bucket: int, p: Dict) -> Dict:
    """Pair ``slot``: the first draw of streams (seed, slot, j) whose two
    fragments together fill ``bucket`` a side."""
    for j in range(64):
        rng = rng_for(seed, slot, j)
        f0, f1, noise, R, overlap = _pair_draw(rng, p)
        sized = _sized([f0, f1], noise, bucket, 2, p)
        if sized is None:
            continue
        t = rng.standard_normal(3) * 0.5
        xyz0, xyz1 = sized[0], (sized[1] + t).astype(np.float32)
        T01 = np.eye(4)
        T01[:3, :3], T01[:3, 3] = R, t
        h, w = p["image_hw"]
        return {"xyz0": rng.permutation(xyz0), "xyz1": rng.permutation(xyz1),
                "image0": rng.random((h, w, 3), dtype=np.float32),
                "image1": rng.random((h, w, 3), dtype=np.float32),
                # gt.log convention: the pose that maps fragment 1 into fragment 0
                "T_gt": np.linalg.inv(T01).astype(np.float32),
                "n_pad": 2 * bucket, "overlap": float(overlap)}
    raise RuntimeError(f"traffic: no draw of pair slot {slot} fills bucket {bucket}")


def fragment(seed: int, slot: int, bucket: int, p: Dict) -> Dict:
    """Fragment ``slot``: fragment 0 of the first draw of streams (seed,
    slot, j) that fills ``bucket`` alone."""
    for j in range(64):
        rng = rng_for(seed, slot, j)
        f0, _, noise, _, _ = _pair_draw(rng, p)
        sized = _sized([f0], noise[:1], bucket, 1, p)
        if sized is not None:
            h, w = p["image_hw"]
            return {"xyz": rng.permutation(sized[0]),
                    "image": rng.random((h, w, 3), dtype=np.float32), "bucket": bucket}
    raise RuntimeError(f"traffic: no draw of fragment slot {slot} fills bucket {bucket}")


def pool(seed: int, p: Dict) -> List[Dict]:
    return [pair(seed, i, b, p) for i, b in enumerate(p["slots"])]


def fragments(seed: int, p: Dict) -> List[Dict]:
    return [fragment(seed, i, b, p) for i, b in enumerate(p["slots"])]
