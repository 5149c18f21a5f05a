"""Port parity, KITTI data: point-to-point ICP, the two KITTI pair datasets
(file lists, samples, the ICP cache), the pair rejection and the scaled
search radius, against the JAX package on the synthetic odometry layout of
``tests/test_kitti_pipeline.py``."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import kitti_config as jax_kitti_config
from imfnet_tpu.data import datasets as jds
from imfnet_tpu.match.icp import icp_point_to_point as jax_icp

from imfnet_tpu_torch.config import kitti_config, threedmatch_config
from imfnet_tpu_torch.data import datasets as pds
from imfnet_tpu_torch.geom.transforms import apply_transform_np
from imfnet_tpu_torch.match.icp import icp_point_to_point
from imfnet_tpu_torch.utils import native

ICP_ATOL = 1e-4    # f32 fits over the same correspondences, sums in another order
GT_ATOL = 1e-5     # the refined ground truth: ICP differs in the last bits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_kitti_root(root, n_points=4000, n_scans=4, extent=20.0, seed=0,
                     far_drive_scans=24):
    """The layout of tests/test_kitti_pipeline.py: drive 00 holds ``n_scans``
    velodyne scans of one cloud moved by a voxel-aligned translation per
    scan (1.5, 0.6, 0) m, with poses chosen so that the closed-form ground
    truth equals that motion; drive 01 holds ``far_drive_scans`` scans of a
    few points with poses 1 m apart, for the >= 10 m pair list. Writes
    test_list.txt (drive 00) and both_list.txt (drives 00 and 01)."""
    rng = np.random.RandomState(seed)
    seq = root / "dataset" / "sequences" / "00" / "velodyne"
    poses_dir = root / "dataset" / "poses"
    os.makedirs(seq)
    os.makedirs(poses_dir, exist_ok=True)
    M = np.eye(4)
    M[:3, 3] = [1.5, 0.6, 0.0]   # multiples of voxel_size 0.3
    base = np.stack([rng.uniform(-extent, extent, n_points),
                     rng.uniform(-extent, extent, n_points),
                     rng.uniform(-1.5, 1.5, n_points)], 1).astype(np.float32)
    Ms = [np.linalg.matrix_power(M, t) for t in range(n_scans)]
    for t in range(n_scans):
        pts = apply_transform_np(base, np.linalg.inv(Ms[t])).astype(np.float32)
        arr = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
        arr.tofile(seq / ("%06d.bin" % t))
    V = pds.velo2cam()
    with open(poses_dir / "00.txt", "w") as f:
        for t in range(n_scans):
            pT = np.linalg.inv(np.linalg.inv(V) @ np.linalg.inv(Ms[t]).T @ V)
            f.write(" ".join(f"{v:.9f}" for v in pT.T[:3].reshape(-1)) + "\n")
    far = root / "dataset" / "sequences" / "01" / "velodyne"
    os.makedirs(far)
    with open(poses_dir / "01.txt", "w") as f:
        for t in range(far_drive_scans):
            np.ones((10, 4), np.float32).tofile(far / ("%06d.bin" % t))
            p = np.eye(4)[:3]
            p[:, 3] = [t * 1.0, 0.1 * t, 0.0]
            f.write(" ".join(f"{v:.9f}" for v in p.reshape(-1)) + "\n")
    with open(root / "test_list.txt", "w") as f:
        f.write("0\n")
    with open(root / "both_list.txt", "w") as f:
        f.write("0\n1\n")
    return root


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return write_kitti_root(tmp_path_factory.mktemp("kitti"))


def _configs(root, **kw):
    common = dict(kitti_root=str(root), max_points=4096, kitti_max_time_diff=4, **kw)
    return (jax_kitti_config(icp_cache_path=str(root / "icp_jax"), **common),
            kitti_config(icp_cache_path=str(root / "icp_port"), **common))


@pytest.mark.parametrize("seed,n,m", [(0, 1500, 2000), (1, 3000, 2500)])
def test_icp_equals_jax(seed, n, m):
    rng = np.random.RandomState(seed)
    base = (rng.rand(max(n, m), 3) * np.array([10.0, 10.0, 2.0])).astype(np.float32)
    dst = base[:m]
    a = 0.05
    T = np.array([[np.cos(a), -np.sin(a), 0, 0.1], [np.sin(a), np.cos(a), 0, -0.05],
                  [0, 0, 1, 0.02], [0, 0, 0, 1]])
    src = apply_transform_np(base[:n], np.linalg.inv(T)) + rng.randn(n, 3) * 0.005
    n_pad = 1 << int(np.ceil(np.log2(max(n, m))))
    sp, dp = np.zeros((n_pad, 3), np.float32), np.zeros((n_pad, 3), np.float32)
    sp[:n], dp[:m] = src, dst
    sv, dv = np.arange(n_pad) < n, np.arange(n_pad) < m
    Tj = np.asarray(jax_icp(jnp.asarray(sp), jnp.asarray(dp), jnp.asarray(sv),
                            jnp.asarray(dv), jnp.eye(4), 0.2, iters=30))
    Tt = icp_point_to_point(torch.from_numpy(sp), torch.from_numpy(dp), torch.from_numpy(sv),
                            torch.from_numpy(dv), torch.eye(4), 0.2, iters=30).numpy()
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=ICP_ATOL)
    np.testing.assert_allclose(Tt, T, rtol=0, atol=1e-2)


def test_count_pairs_within_radius():
    rng = np.random.RandomState(2)
    src, dst = rng.rand(500, 3), rng.rand(700, 3)
    d = np.linalg.norm(src[:, None] - dst[None], axis=-1)
    assert native.count_pairs_within_radius(src, dst, 0.1) == int((d <= 0.1).sum())
    assert native.count_pairs_within_radius(src[:0], dst, 0.1) == 0


@pytest.mark.parametrize("name", ["KITTIPairDataset", "KITTINMPairDataset"])
def test_file_lists_equal_jax(kitti_root, monkeypatch, name):
    for mod in (jds, pds):
        monkeypatch.setitem(getattr(mod, name).DATA_FILES, "test",
                            str(kitti_root / "both_list.txt"))
    jc, pc = _configs(kitti_root)
    a = getattr(jds, name)("test", jc, random_rotation=False, random_scale=False)
    b = getattr(pds, name)("test", pc, random_rotation=False, random_scale=False,
                           icp_device="cpu")
    assert b.files == a.files and len(a.files) > 0
    assert pds.dataset_class(name) is getattr(pds, name)
    # the split lists are the port's own copy, equal to the JAX package's
    for split in ("train", "val", "test"):
        with open(pds._resolve_data_file(f"./config/{split}_kitti.txt")) as x, \
                open(jds._resolve_data_file(f"./config/{split}_kitti.txt")) as y:
            assert x.read() == y.read()


@pytest.fixture(scope="module")
def samples(kitti_root):
    """Every test pair of drive 00 from both packages' KITTIPairDataset."""
    list_file = str(kitti_root / "test_list.txt")
    jc, pc = _configs(kitti_root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jds.KITTIPairDataset.DATA_FILES, "test", list_file)
        mp.setitem(pds.KITTIPairDataset.DATA_FILES, "test", list_file)
        a = jds.KITTIPairDataset("test", jc, random_rotation=False, random_scale=False)
        b = pds.KITTIPairDataset("test", pc, random_rotation=False, random_scale=False,
                                 icp_device="cpu")
    return [(a[i], b[i]) for i in range(len(a))], b


def test_samples_equal_jax(samples):
    pairs, _ = samples
    assert len(pairs) == 3
    for a, b in pairs:
        for k in ("coords0", "coords1", "xyz0", "xyz1", "feats0", "feats1", "image0", "image1"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
        np.testing.assert_allclose(b.T_gt, a.T_gt, rtol=0, atol=GT_ATOL)
        assert b.search_radius == a.search_radius
        # the refined ground truth aligns the voxelized clouds
        from scipy.spatial import cKDTree
        d, _ = cKDTree(b.xyz1).query(apply_transform_np(b.xyz0, b.T_gt))
        assert np.median(d) < 0.3


def test_icp_cache_is_written_and_read_back(samples, kitti_root, monkeypatch):
    pairs, dset = samples
    names = sorted(os.listdir(kitti_root / "icp_port"))
    assert names == ["0_0_2.npy", "0_0_3.npy", "0_1_3.npy"]
    for name, (_, b) in zip(names, pairs):
        np.testing.assert_allclose(np.load(kitti_root / "icp_port" / name), b.T_gt,
                                   rtol=0, atol=1e-6)
    # a new process's dataset (empty memory cache) reads the files, no ICP
    monkeypatch.setattr(pds, "_kitti_icp_cache", {})
    monkeypatch.setattr(pds.KITTIPairDataset, "_run_icp", staticmethod(
        lambda *a, **k: pytest.fail("ICP ran despite the .npy cache")))
    again = pds.KITTIPairDataset.__new__(pds.KITTIPairDataset)
    again.__dict__.update(dset.__dict__)
    np.testing.assert_array_equal(again[0].T_gt, pairs[0][1].T_gt)


def test_pair_rejection_counted():
    """<1000-match pairs raise in __getitem__ and PairLoader counts the skip
    (tests/test_kitti_pipeline.py::test_pair_rejection_counted)."""
    config = threedmatch_config(max_points=4096)

    class Flaky(pds.SyntheticPairDataset):
        def __getitem__(self, idx):
            if idx % 2 == 1:
                raise ValueError(f"pair {idx}: too few matches")
            return super().__getitem__(idx)

    loader = pds.PairLoader(Flaky("val", config, length=6, n_points=500), 1,
                            config.max_points, shuffle=False, drop_last=False)
    assert len(list(loader)) == 3 and loader.skip_count == 3


def test_kitti_sample_rejected_below_1000_matches(kitti_root, monkeypatch):
    list_file = str(kitti_root / "test_list.txt")
    monkeypatch.setitem(pds.KITTIPairDataset.DATA_FILES, "test", list_file)
    monkeypatch.setattr(pds, "count_pairs_within_radius", lambda *a: 999)
    _, pc = _configs(kitti_root)
    dset = pds.KITTIPairDataset("test", pc, random_rotation=False, random_scale=False,
                                icp_device="cpu")
    with pytest.raises(ValueError, match="0, 0, 2"):
        dset[0]


def test_scale_scales_search_radius():
    """The positive-search radius carries the sampled random scale
    (tests/test_kitti_pipeline.py::test_scale_scales_search_radius)."""
    config = threedmatch_config(use_random_scale=True)
    dset = pds.PairDataset("train", config, random_rotation=False, random_scale=True,
                           manual_seed=True)
    xyz = np.random.RandomState(3).rand(100, 3).astype(np.float32)
    radii = set()
    for _ in range(8):
        x0, _, _, radius = dset._augment(xyz.copy(), xyz.copy())
        scale = float(x0[0, 0] / xyz[0, 0])
        assert radius == pytest.approx(dset.matching_search_voxel_size * scale, rel=1e-5)
        radii.add(round(radius, 6))
    assert len(radii) > 1
