"""Port parity, the data path: augmentations, image and PLY readers, the
datasets and the batch loader against the JAX package on the same seeds and
files. Everything here is numpy on the host, so the results are held
byte-equal (``assert_array_equal``; no tolerance)."""
import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data import datasets as jds
from imfnet_tpu.geom import image as jimage
from imfnet_tpu.geom import transforms as jtf
from imfnet_tpu.geom.ply import read_ply as jax_read_ply
from imfnet_tpu.geom.ply import write_ply
from imfnet_tpu.geom.trajectory import CameraPose as JaxCameraPose
from imfnet_tpu.geom.trajectory import write_trajectory as jax_write_trajectory

from imfnet_tpu_torch.config import kitti_config, threedmatch_config
from imfnet_tpu_torch.data import datasets as pds
from imfnet_tpu_torch.geom import image as pimage
from imfnet_tpu_torch.geom import trajectory as ptraj
from imfnet_tpu_torch.geom import transforms as ptf
from imfnet_tpu_torch.geom.ply import read_ply
from imfnet_tpu_torch.utils import timer as ptimer

SMALL = dict(dataset="SyntheticPairDataset", synthetic_length=6, synthetic_n_points=400,
             batch_size=2, max_points=2048, voxel_size=0.05, image_H=24, image_W=32)


def _same_pair(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _same_batch(pb, jb):
    """Every field of a port batch (host tensors) and a JAX batch."""
    for name in jb._fields:
        x, y = getattr(pb, name), getattr(jb, name)
        if y is None:
            assert x is None, name
            continue
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu", name
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape and x.numpy().dtype == y.dtype, name
        np.testing.assert_array_equal(x.numpy(), y, err_msg=name)


# ---- geom ---------------------------------------------------------------------

def test_random_transforms_and_jitter_draw_the_same_stream():
    pts = np.random.RandomState(1).randn(200, 3)
    feats = np.ones((50, 4), np.float32)
    coords = np.arange(150, dtype=np.int32).reshape(50, 3)
    ra, rb = np.random.RandomState(5), np.random.RandomState(5)
    ja = jtf.Compose([jtf.Jitter(), jtf.ChromaticShift()])
    pa = ptf.Compose([ptf.Jitter(), ptf.ChromaticShift()])
    for rot in (360.0, 45.0, 360.0):
        Tj, Tp = jtf.sample_random_trans(pts, ra, rot), ptf.sample_random_trans(pts, rb, rot)
        np.testing.assert_array_equal(Tp, Tj)
        np.testing.assert_array_equal(ptf.apply_transform_np(pts, Tp),
                                      jtf.apply_transform_np(pts, Tj))
        for _ in range(8):   # both branches of the p = 0.95 draws
            (cj, fj), (cp, fp) = ja(ra, coords, feats), pa(rb, coords, feats)
            np.testing.assert_array_equal(fp, fj)
            np.testing.assert_array_equal(cp, cj)
    assert ra.rand() == rb.rand()   # the streams are still aligned


@pytest.mark.parametrize("shape,aim", [((48, 64, 3), (24, 32)), ((30, 50, 4), (24, 32)),
                                       ((17, 23), (24, 32)), ((24, 32, 3), (24, 32))])
def test_process_image_and_resize(shape, aim):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got, ref = pimage.process_image(img, *aim), jimage.process_image(img, *aim)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == aim + (3,)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(pimage._bilinear_resize_np(img, 11, 7),
                                  jimage._bilinear_resize_np(img, 11, 7))


def test_load_and_save_image(tmp_path):
    img = np.random.RandomState(0).rand(20, 30, 3).astype(np.float32)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    pimage.save_image(a, img)
    jimage.save_image(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(pimage.load_image(a), jimage.load_image(a))
    grey = (img[..., 0] * 255).astype(np.uint8)
    pimage.save_image(a, grey)
    assert pimage.load_image(a).shape == (20, 30, 3)
    np.testing.assert_array_equal(pimage.load_image(a), jimage.load_image(a))


@pytest.mark.parametrize("fmt", ["binary", "binary_colors_normals", "ascii"])
def test_read_ply(tmp_path, fmt):
    rng = np.random.RandomState(0)
    pts = rng.randn(40, 3).astype(np.float32)
    path = str(tmp_path / "c.ply")
    if fmt == "ascii":
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\nelement vertex 40\nproperty float x\n"
                    "property float y\nproperty float z\nelement face 1\n"
                    "property list uchar int vertex_indices\nend_header\n")
            for p in pts:
                f.write(" ".join(repr(float(v)) for v in p) + "\n")
            f.write("3 0 1 2\n")
    elif fmt == "binary":
        write_ply(path, pts)
    else:
        write_ply(path, pts, colors=rng.rand(40, 3), normals=rng.randn(40, 3))
    got, ref = read_ply(path), jax_read_ply(path)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    with open(path, "wb") as f:
        f.write(b"not a ply\n")
    with pytest.raises(ValueError, match="not a PLY"):
        read_ply(path)


def test_trajectory_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    traj = [JaxCameraPose([i, i + 1, 5], rng.randn(4, 4)) for i in range(3)]
    path = str(tmp_path / "gt.log")
    jax_write_trajectory(traj, path)
    got = ptraj.read_log(path)
    assert [t.metadata for t in got] == [t.metadata for t in traj]
    for g, t in zip(got, traj):
        np.testing.assert_allclose(g.pose, t.pose, rtol=0, atol=1e-11)   # 12 decimals
        np.testing.assert_array_equal(g.transformation, g.pose)
    out = str(tmp_path / "out.log")
    ptraj.write_trajectory(got, out)
    with open(out) as a, open(path) as b:
        assert a.read() == b.read()
    info = str(tmp_path / "gt.info")
    with open(info, "w") as f:
        f.write("0 1 5\n" + "\n".join(" ".join(str(float(i == j)) for j in range(6))
                                      for i in range(6)) + "\n")
    (rec,) = ptraj.read_info_file(info)
    assert rec["test_pair"] == [0, 1] and rec["num_fragments"] == 5
    np.testing.assert_array_equal(rec["covariance"], np.eye(6, dtype=np.float32))


def test_meters_and_timers():
    m = ptimer.AverageMeter()
    for v, n in ((1.0, 1), (3.0, 2), (5.0, 1)):
        m.update(v, n)
    assert m.avg == 3.0 and m.val == 5.0 and m.count == 4 and m.min == 1.0 and m.max == 5.0
    np.testing.assert_allclose(m.var, np.var([1.0, 3.0, 3.0, 5.0]), rtol=1e-12)
    t = ptimer.Timer()
    for _ in range(2):
        t.tic()
        time.sleep(0.01)
        t.toc()
    with t:
        pass
    assert t.count == 3 and t.avg > 0 and t.diff == t.last and t.total_time >= 0.02
    assert ptimer.MinTimer().min == float("inf")
    # the torch.profiler counterpart of the JAX profiler's trace, held in
    # test_torch_port_surface.py
    assert callable(ptimer.device_trace)


# ---- datasets -----------------------------------------------------------------

@pytest.mark.parametrize("scale,rotation", [(True, True), (False, True), (True, False),
                                            (False, False)])
def test_augment_and_finalize_keep_the_stream_aligned(scale, rotation):
    """Several samples in a row through ``_augment`` and ``_finalize`` with a
    jitter transform: every output equal, and so the streams after them."""
    cfg = dict(voxel_size=0.05, min_scale=0.7, max_scale=1.3, rotation_range=180.0)
    kw = dict(random_rotation=rotation, random_scale=scale)
    jd = jds.PairDataset("train", jax_config(**cfg), transform=jds._compose_jitter(), **kw)
    pd = pds.PairDataset("train", threedmatch_config(**cfg),
                         transform=pds._compose_jitter(), **kw)
    jd.reset_seed(3)
    pd.reset_seed(3)
    rng = np.random.RandomState(0)
    img = rng.rand(4, 5, 3).astype(np.float32)
    for k in range(4):
        xyz0, xyz1 = rng.rand(300, 3) * 2.0, rng.rand(250, 3) * 2.0
        base = None if k % 2 else ptf.sample_random_trans(xyz0, rng)
        aj, ap = jd._augment(xyz0, xyz1, base), pd._augment(xyz0, xyz1, base)
        for x, y in zip(ap, aj):
            np.testing.assert_array_equal(x, y)
        _same_pair(pd._finalize(*ap[:3], img, img, ap[3]),
                   jd._finalize(*aj[:3], img, img, aj[3]))
    assert jd.randg.rand() == pd.randg.rand()


@pytest.mark.parametrize("phase", ["train", "val"])
def test_synthetic_dataset_samples_are_equal(phase):
    kw = dict(SMALL, seed=11)
    jd = jds.SyntheticPairDataset(phase, jax_config(**kw))
    pd = pds.SyntheticPairDataset(phase, threedmatch_config(**kw))
    assert len(jd) == len(pd) == 6
    for i in (0, 3, 5):
        _same_pair(pd[i], jd[i])
    other = pds.SyntheticPairDataset(phase, threedmatch_config(**dict(kw, seed=12)))[0]
    same = np.array_equal(other.xyz0, pd[0].xyz0)
    assert same == (phase == "val")   # only the train stream mixes the seed in


@pytest.fixture(scope="module")
def threedmatch_dir(tmp_path_factory):
    """A 3DMatch-shaped directory: fragments (PLY + ``_0.png``) of the three
    validation scenes with one overlap list each, and one test scene with
    its ``gt.log``."""
    root = tmp_path_factory.mktemp("threedmatch")
    overlap = root / "overlap"
    overlap.mkdir()
    rng = np.random.RandomState(0)

    def fragment(path, with_image=True):
        write_ply(str(path) + ".ply", (rng.rand(600, 3) * 1.5).astype(np.float32))
        if with_image:
            jimage.save_image(str(path) + "_0.png", rng.rand(30, 40, 3).astype(np.float32))

    for scene in open(os.path.join(os.path.dirname(jds.__file__), "config",
                                   "val_3dmatch.txt")).read().split():
        (root / scene).mkdir()
        names = [f"{scene}/cloud_bin_{k}" for k in range(3)]
        for k, n in enumerate(names):
            fragment(root / n, with_image=k != 2)   # one fragment has no image
        with open(overlap / f"{scene}-0.30.txt", "w") as f:
            f.write(f"{names[0]}.ply {names[1]}.ply 0.5\n\n{names[1]}.ply {names[2]}.ply 0.4\n")
    test_scenes = open(os.path.join(os.path.dirname(jds.__file__), "config",
                                    "test_3dmatch.txt")).read().split()
    scene = test_scenes[1]
    (root / scene).mkdir()
    (root / f"{scene}-evaluation").mkdir()
    for k in range(3):
        fragment(root / scene / f"cloud_bin_{k}", with_image=False)
    jax_write_trajectory([JaxCameraPose([0, 1, 3], np.eye(4)),
                          JaxCameraPose([1, 2, 3], ptf.sample_random_trans(rng.rand(9, 3), rng))],
                         str(root / f"{scene}-evaluation" / "gt.log"))
    return dict(root=str(root), overlap=str(overlap), test_scene_id=1, test_scene=scene)


def test_threedmatch_pair_dataset_on_written_files(threedmatch_dir):
    kw = dict(threed_match_dir=threedmatch_dir["root"], overlap_path=threedmatch_dir["overlap"],
              voxel_size=0.05, image_H=24, image_W=32, use_random_scale=True)
    aug = dict(random_rotation=True, random_scale=True)
    jd = jds.ThreeDMatchPairDataset("val", jax_config(**kw), transform=jds._compose_jitter(),
                                    **aug)
    pd = pds.ThreeDMatchPairDataset("val", threedmatch_config(**kw),
                                    transform=pds._compose_jitter(), **aug)
    assert isinstance(pd, pds.IndoorPairDataset) and pd.files == jd.files and len(pd) >= 6
    jd.reset_seed(2)
    pd.reset_seed(2)
    for i in (0, 1, 5, 0):
        sp, sj = pd[i], jd[i]
        _same_pair(sp, sj)
        assert sp.image0.shape == (24, 32, 3) and sp.search_radius > 0
    assert not pd[1].image1.any()   # the missing image comes out as zeros
    with pytest.raises(FileNotFoundError, match="Missing overlap files"):
        pds.ThreeDMatchPairDataset("train", threedmatch_config(**kw))


def test_threedmatch_test_dataset_on_written_files(threedmatch_dir):
    kw = dict(threed_match_dir=threedmatch_dir["root"])
    sid = threedmatch_dir["test_scene_id"]
    jd = jds.ThreeDMatchTestDataset("test", jax_config(**kw), scene_id=sid)
    pd = pds.ThreeDMatchTestDataset("test", threedmatch_config(**kw), scene_id=sid)
    assert len(pd) == len(jd) == 2
    for i in range(2):
        (sn, a0, a1, Ta), (_, b0, b1, Tb) = pd[i], jd[i]
        assert sn == threedmatch_dir["test_scene"]
        for x, y in ((a0, b0), (a1, b1), (Ta, Tb)):
            np.testing.assert_array_equal(x, y)
    names = pds.ThreeDMatchTestDataset("test", threedmatch_config(**kw), scene_id=sid,
                                       return_ply_names=True)[1]
    assert names[1].endswith("cloud_bin_1.ply") and names[2].endswith("cloud_bin_2.ply")
    with pytest.raises(FileNotFoundError):   # the other scenes have no gt.log here
        pds.ThreeDMatchTestDataset("test", threedmatch_config(**kw))
    with pytest.raises(ValueError, match="test phase"):
        pds.ThreeDMatchTestDataset("val", threedmatch_config(**kw))


def test_split_lists_are_the_reference_ones():
    for name in ("train_3dmatch.txt", "val_3dmatch.txt", "test_3dmatch.txt"):
        with open(pds._resolve_data_file(f"./config/{name}")) as a, \
                open(jds._resolve_data_file(f"./config/{name}")) as b:
            assert a.read() == b.read()
    with pytest.raises(FileNotFoundError, match="split list not found"):
        pds._resolve_data_file("./config/no_such_split.txt")


def test_kitti_datasets_are_refused_until_ported(tmp_path):
    """Ported since: a KITTI config builds its dataset, which finds no scans
    under an empty root, as the JAX package's does; an unknown name is
    refused; the port knows every dataset the JAX package knows."""
    cfg = kitti_config(kitti_root=str(tmp_path))
    with pytest.raises(AssertionError, match="no velodyne data"):
        pds.make_data_loader(cfg, "train", 1, device="cpu")
    with pytest.raises(ValueError, match="unknown dataset"):
        pds.make_data_loader(threedmatch_config(dataset="NoSuchDataset"), "train", 1)
    assert set(pds.dataset_str_mapping) == set(jds.dataset_str_mapping)
    assert pds.dataset_class(cfg.dataset) is pds.KITTINMPairDataset


# ---- the loader ---------------------------------------------------------------

@pytest.mark.parametrize("phase", ["train", "val", "test"])
def test_loader_batches_equal_over_two_epochs(phase):
    kw = dict(SMALL, seed=4)
    jl = jds.make_data_loader(jax_config(**kw), phase, 2)
    pl = pds.make_data_loader(threedmatch_config(**kw), phase, 2)
    assert len(pl) == len(jl) == 3 and pl.shuffle == jl.shuffle == (phase != "test")
    assert pl.grid_extent == jl.grid_extent == (256, 256, 256) and pl.shard is None
    for _ in range(2):
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == 3
        for a, b in zip(pb, jb):
            _same_batch(a, b)
    np.testing.assert_array_equal(pl._epoch_indices(), jl._epoch_indices())
    assert pds.make_data_loader(threedmatch_config(**dict(kw, use_grid_maps=False)),
                                phase, 2).grid_extent is None


def test_loader_len_and_drop_last():
    ds = pds.SyntheticPairDataset("val", threedmatch_config(**dict(SMALL, synthetic_length=5)))
    jd = jds.SyntheticPairDataset("val", jax_config(**dict(SMALL, synthetic_length=5)))
    for drop in (True, False):
        pl = pds.PairLoader(ds, 2, 2048, shuffle=False, drop_last=drop)
        jl = jds.PairLoader(jd, 2, 2048, shuffle=False, drop_last=drop)
        got = list(pl)
        assert len(pl) == len(jl) == len(got) == (2 if drop else 3)
        assert got[-1].image0.shape[0] == (2 if drop else 1)


@pytest.mark.parametrize("total,expect", [(8, 4), (10, 4)])
def test_loader_shard_partitions_the_epoch(total, expect):
    """shard=(rank, world, group): groups of 2 batches rotate over 2 ranks,
    only complete rounds are kept, and the union is the unsharded epoch in
    step order."""
    cfg = threedmatch_config(**dict(SMALL, synthetic_length=total, use_random_rotation=False))

    def t_gts(shard):
        loader = pds.make_data_loader(cfg, "train", 1)
        loader.shard = shard
        out = [b.T_gt.numpy()[0] for b in loader]
        assert len(out) == len(loader)
        return out

    full, r0, r1 = t_gts(None), t_gts((0, 2, 2)), t_gts((1, 2, 2))
    assert len(full) == total and len(r0) == len(r1) == expect
    interleaved = r0[0:2] + r1[0:2] + r0[2:4] + r1[2:4]
    for a, b in zip(full, interleaved):
        np.testing.assert_array_equal(a, b)


class _Faulty(pds.SyntheticPairDataset):
    def __getitem__(self, idx):
        if idx == 2:
            raise ValueError("too few matches")      # skippable, as a KITTI pair
        if idx == 4:
            raise OSError("disk gone")
        return super().__getitem__(idx)


def test_loader_skips_value_errors_and_surfaces_the_rest():
    ds = _Faulty("val", threedmatch_config(**SMALL))
    loader = pds.PairLoader(ds, 2, 2048, shuffle=False)
    got = []
    with pytest.raises(OSError, match="disk gone"):
        for b in loader:
            got.append(b)
    assert len(got) == 2 and loader.skip_count == 1
    assert got[1].image0.shape[0] == 1          # the short batch of the skipped sample


def test_loader_refuses_a_sample_beyond_the_grid_extent():
    cfg = threedmatch_config(**dict(SMALL, grid_extent=(16, 16, 16)))
    with pytest.raises(RuntimeError, match="grid_extent"):
        next(iter(pds.make_data_loader(cfg, "train", 2)))


def test_loader_thread_ends_when_the_consumer_stops_early():
    before = set(threading.enumerate())
    loader = pds.make_data_loader(threedmatch_config(**SMALL), "val", 1)
    it = iter(loader)
    next(it)
    (producer,) = set(threading.enumerate()) - before
    it.close()
    producer.join(timeout=10)
    assert not producer.is_alive()
