"""Traffic is a function of the seed: the same seed gives the same inputs,
another seed other geometry with the same sizes."""
import numpy as np

from traffic import kitti, surface

P = {"slots": [8192, 12288], "points": 20000, "fill": 0.5, "overlap": [0.3, 0.9],
     "image_hw": [12, 16], "voxel_size": 0.025, "grid_extent": [256, 256, 256],
     "capacity_divisors": [1, 3, 8, 20]}
K = {"pool": 1, "world_points": 40000, "radius_m": 12.0, "baseline_m": [10.0, 12.0],
     "yaw_deg": 10.0, "points": 8000, "noise_m": 0.01, "image_hw": [12, 16],
     "voxel_size": 0.3}
BIG = (1 << 31) + 12345


def test_pairs_repeat_per_seed_and_differ_across_seeds():
    a, b, c = surface.pool(BIG, P), surface.pool(BIG, P), surface.pool(BIG + 1, P)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in ("xyz0", "xyz1", "image0", "T_gt"))
    assert not np.array_equal(a[0]["xyz0"][:100], c[0]["xyz0"][:100])


def test_sizes_do_not_move_with_the_seed():
    for seed in (BIG, 7, 2 ** 33 + 1):
        for q, bucket in zip(surface.pool(seed, P), P["slots"]):
            n = (surface.voxel_count(q["xyz0"], 0.025) + surface.voxel_count(q["xyz1"], 0.025))
            lower = max([b for b in surface.VOXEL_BUCKETS if b < bucket], default=0)
            assert 2 * lower < n <= 2 * bucket and q["n_pad"] == 2 * bucket


def test_fragments_fill_their_bucket():
    for f, bucket in zip(surface.fragments(BIG, P), P["slots"]):
        lower = max([b for b in surface.VOXEL_BUCKETS if b < bucket], default=0)
        assert lower < surface.voxel_count(f["xyz"], 0.025) <= bucket


def test_kitti_scans_repeat_per_seed_and_differ_across_seeds():
    a, b, c = kitti.pool(BIG, K), kitti.pool(BIG, K), kitti.pool(BIG + 1, K)
    assert np.array_equal(a[0]["coords0"], b[0]["coords0"])
    assert np.array_equal(a[0]["T_gt"], b[0]["T_gt"])
    assert not np.array_equal(a[0]["T_gt"], c[0]["T_gt"])
    # voxels are unique, and each keeps its first point
    v = a[0]["coords0"]
    assert len(np.unique(v, axis=0)) == len(v)
    cells = np.floor(a[0]["xyz0"] / np.float32(0.3)).astype(np.int32)
    assert np.array_equal(cells, v)
