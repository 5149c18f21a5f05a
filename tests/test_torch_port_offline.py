"""Port parity, the offline tools and the native host library: TSDF
integration, fusion, overlap lists and radii against the JAX package's
functions on the same inputs, the three subcommands against the JAX
commands file for file, and ``voxel_dedup`` / ``count_within_radius`` /
``count_pairs_within_radius`` with the native library and with the numpy
fallback; ``voxelize_np``'s output is unchanged."""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from imfnet_tpu.cli import main as jax_main
from imfnet_tpu.data import offline as joff
from imfnet_tpu.geom.ply import read_ply as jax_read_ply
from imfnet_tpu.utils import native as jnative

from imfnet_tpu_torch import cli
from imfnet_tpu_torch.data import offline as poff
from imfnet_tpu_torch.data.collate import voxelize_np
from imfnet_tpu_torch.geom.ply import read_ply
from imfnet_tpu_torch.utils import native as pnative

from test_torch_port_extract import _boundary_points

H, W = 48, 64
K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
TSDF_ATOL = 1e-5        # running TSDF means: f32, the projection's sums in another order
TSDF_FLIPS = 0.001      # voxels whose rounding or validity may flip at a pixel's edge
POINT_ATOL = 1e-9       # fused points are voxel centres: equal wherever the voxel is


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _depth(i):
    """A bumpy wall about 1 m ahead, a few invalid pixels."""
    v, u = np.mgrid[0:H, 0:W]
    d = 1.0 + 0.08 * np.sin(u / 5.0 + i) + 0.05 * np.cos(v / 7.0)
    d[(u + 3 * v + i) % 29 == 0] = 0.0
    return d.astype(np.float32)


def _pose(i):
    a = 0.03 * i
    pose = np.eye(4)
    pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    pose[:3, 3] = [0.02 * i, -0.01 * i, 0.005 * i]
    return pose


def test_tsdf_integration_equals_jax():
    dims, origin, voxel, trunc = (40, 36, 28), np.array([-0.6, -0.5, 0.6], np.float32), 0.03, 0.08
    pv = poff.TSDFVolume(origin, dims=dims, voxel=voxel, trunc=trunc, device="cpu")
    jv = joff.TSDFVolume(origin, dims=dims, voxel=voxel, trunc=trunc)
    for i in range(4):
        cam_from_world = np.linalg.inv(_pose(i))
        pv.integrate(_depth(i), K, cam_from_world)
        jv.integrate(_depth(i), K, cam_from_world)
    w, jw = pv.weight.numpy(), np.asarray(jv.weight)
    t, jt = pv.tsdf.numpy(), np.asarray(jv.tsdf)
    same = w == jw
    assert (~same).mean() <= TSDF_FLIPS and w.max() == 4
    np.testing.assert_allclose(t[same], jt[same], rtol=0, atol=TSDF_ATOL)
    a, b = pv.extract_point_cloud(), jv.extract_point_cloud()
    assert len(a) > 500 and abs(len(a) - len(b)) <= TSDF_FLIPS * w.size
    common = {tuple(p) for p in np.round(a / voxel).astype(int)} & \
        {tuple(p) for p in np.round(b / voxel).astype(int)}
    assert len(common) >= 0.99 * max(len(a), len(b))


def _write_sequence(root, n_frames):
    seq = root / "scene" / "seq-01"
    seq.mkdir(parents=True)
    np.savetxt(root / "scene" / "camera-intrinsics.txt", K)
    for i in range(n_frames):
        Image.fromarray((_depth(i) * 1000).astype(np.uint16)).save(
            seq / f"frame-{i:06d}.depth.png")
        np.savetxt(seq / f"frame-{i:06d}.pose.txt", _pose(i))
    return root / "scene"


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_subcommands_equal_the_jax_commands(tmp_path, capsys, monkeypatch):
    """fuse-fragments → compute-overlap → compute-radius, both packages on
    one depth sequence: the fused clouds (voxel centres) equal up to the
    TSDF's edge flips, then on the JAX package's fragments the overlap
    lists, correspondences, ratios and radii equal."""
    scene = _write_sequence(tmp_path, 8)
    fuse = ["--scene-dir", str(scene), "--frames-per-fragment", "2", "--resolution", "64",
            "--cubic-size", "3.0"]
    jax_main(["fuse-fragments", *fuse, "--out-dir", str(tmp_path / "jf")])
    jout = _json_line(capsys)
    cli.main(["fuse-fragments", *fuse, "--out-dir", str(tmp_path / "pf"), "--device", "cpu"])
    pout = _json_line(capsys)
    assert [os.path.basename(p) for p in pout["fragments"]] == \
        [os.path.basename(p) for p in jout["fragments"]] and len(pout["fragments"]) == 4
    for p, j in zip(pout["fragments"], jout["fragments"]):
        a, b = read_ply(p)["points"], jax_read_ply(j)["points"]
        assert len(a) > 200 and abs(len(a) - len(b)) <= 0.01 * len(b)
        sa, sb = {tuple(r) for r in a}, {tuple(r) for r in b}
        assert len(sa & sb) >= 0.99 * len(sb)
        np.testing.assert_array_equal(np.load(p[:-4] + ".pose.npy"), np.load(j[:-4] + ".pose.npy"))

    frags = str(tmp_path / "jf")
    ov = ["--fragments-dir", frags, "--dist-thresh", "0.08", "--min-overlap", "0.2"]
    jax_main(["compute-overlap", *ov, "--out-dir", str(tmp_path / "jo")])
    jpairs = _json_line(capsys)["pairs"]
    cli.main(["compute-overlap", *ov, "--out-dir", str(tmp_path / "po"), "--device", "cpu"])
    ppairs = _json_line(capsys)["pairs"]
    assert [p[:2] for p in ppairs] == [p[:2] for p in jpairs] and len(ppairs) >= 2
    for (a, b, r), (_, _, jr) in zip(ppairs, jpairs):
        assert r == pytest.approx(jr, abs=1e-6)
        np.testing.assert_array_equal(np.load(tmp_path / "po" / f"{a}-{b}.npy"),
                                      np.load(tmp_path / "jo" / f"{a}-{b}.npy"))
        assert (tmp_path / "po" / f"{a}-{b}-overlap.txt").read_text() == str(r)

    jax_main(["compute-radius", "--fragments-dir", frags, "--nn-radius", "0.1"])
    jfiles = _json_line(capsys)["radius_files"]
    jradii = [np.load(f) for f in jfiles]
    cli.main(["compute-radius", "--fragments-dir", frags, "--nn-radius", "0.1",
              "--device", "cpu"])
    pfiles = _json_line(capsys)["radius_files"]
    assert pfiles == jfiles
    for f, r in zip(pfiles, jradii):
        got = np.load(f)
        assert got.dtype == np.float32 and (got > 0).mean() > 0.9
        np.testing.assert_allclose(got, r, rtol=0, atol=1e-6)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["fuse-fragments", *fuse, "--out-dir", str(tmp_path / "x")],
                 ["compute-overlap", *ov, "--out-dir", str(tmp_path / "y")],
                 ["compute-radius", "--fragments-dir", frags]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)


def _overlap_clouds(seed):
    """Two clouds sharing 400 points (moved by 2 mm of noise, so no two
    points coincide), each with points of its own."""
    rng = np.random.RandomState(seed)
    base = rng.rand(900, 3).astype(np.float32)
    a = base[:600]
    b = np.concatenate([base[200:600] + rng.randn(400, 3).astype(np.float32) * 0.002,
                        rng.rand(150, 3).astype(np.float32) + 5])
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_overlap_pair_and_lists_equal_jax(tmp_path, seed):
    a, b = _overlap_clouds(seed)
    ratio, corr = poff.compute_overlap_pair(a, b, dist_thresh=0.01, device="cpu")
    jratio, jcorr = joff.compute_overlap_pair(a, b, dist_thresh=0.01)
    assert ratio == jratio and 0.4 < ratio < 0.8
    np.testing.assert_array_equal(corr, jcorr)
    frags = [("cloud_bin_0", a), ("cloud_bin_1", b), ("cloud_bin_5", b), ("cloud_bin_7", a)]
    kept = poff.build_overlap_lists(frags, str(tmp_path / "p"), dist_thresh=0.01,
                                    min_overlap=0.3, device="cpu")
    jkept = joff.build_overlap_lists(frags, str(tmp_path / "j"), dist_thresh=0.01,
                                     min_overlap=0.3)
    assert kept == jkept and ("cloud_bin_0", "cloud_bin_1", ratio) not in kept
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))


def test_radius_and_down_sample_equal_jax():
    g = np.stack(np.meshgrid(*[np.arange(6) * 0.1] * 3), -1).reshape(-1, 3)
    rng = np.random.RandomState(4)
    pts = np.concatenate([g + rng.randn(*g.shape) * 0.004, rng.rand(300, 3) * 3])
    for k, r in ((16, 0.1), (6, 0.12), (400, 0.5)):
        np.testing.assert_allclose(poff.compute_radius(pts, nn_radius=r, k=k, device="cpu"),
                                   joff.compute_radius(pts, nn_radius=r, k=k), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(poff.compute_radius(pts[:3], device="cpu"),
                                  joff.compute_radius(pts[:3]))
    x = (rng.rand(5000, 3) * 2).astype(np.float32)
    np.testing.assert_array_equal(poff.voxel_down_sample_np(x, 0.1),
                                  joff.voxel_down_sample_np(x, 0.1))


def test_extract_surface_and_depth_reader_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    dims = (10, 12, 14)
    t = rng.uniform(-1, 1, np.prod(dims)).astype(np.float32)
    w = rng.randint(0, 4, np.prod(dims)).astype(np.float32)
    origin = np.array([0.1, -0.2, 0.3])
    np.testing.assert_array_equal(poff.extract_surface(torch.from_numpy(t), torch.from_numpy(w),
                                                       origin, 0.05, dims),
                                  joff.extract_surface(t, w, origin, 0.05, dims))
    d = (rng.rand(H, W) * 8000).astype(np.uint16)
    Image.fromarray(d).save(tmp_path / "d.png")
    np.testing.assert_array_equal(poff.read_depth_png(str(tmp_path / "d.png")),
                                  joff.read_depth_png(str(tmp_path / "d.png")))


# ---- the native host library -------------------------------------------------

@pytest.fixture(params=["native", "fallback"])
def library(request, monkeypatch):
    """Both modules with their native library, or both on the fallback."""
    if request.param == "native":
        assert pnative.have_native() and jnative.have_native()
    else:
        for mod in (pnative, jnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    return request.param


def _cloud(seed, voxel):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(4000, 3) * 1.5 - 2).astype(np.float32)
    xyz[1000:1100] = xyz[:100]                                   # exact duplicates
    b = _boundary_points(voxel)
    xyz[2000:2000 + len(b) // 3, 1] = b[:len(b) // 3]           # on cell boundaries
    return xyz


@pytest.mark.parametrize("voxel", [0.025, 0.1, 0.3])
def test_voxel_dedup_equals_jax(library, voxel):
    xyz = _cloud(0, voxel)
    c, s = pnative.voxel_dedup(xyz, voxel)
    jc, js = jnative.voxel_dedup(xyz, voxel)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(s, js)
    assert c.dtype == np.int32 and s.dtype == np.int32 and (np.diff(s) > 0).all()
    c2, s2 = pnative.voxel_dedup(xyz, voxel, max_out=100)
    jc2, js2 = jnative.voxel_dedup(xyz, voxel, max_out=100)
    np.testing.assert_array_equal(s2, js2)
    np.testing.assert_array_equal(c2, jc2)


def test_radius_counts_equal_jax(library):
    rng = np.random.RandomState(6)
    src = rng.rand(600, 3).astype(np.float32)
    dst = np.concatenate([src[:400] + rng.randn(400, 3).astype(np.float32) * 0.01,
                          rng.rand(200, 3).astype(np.float32)])
    for r in (0.005, 0.02, 0.1):
        assert pnative.count_within_radius(src, dst, r) == jnative.count_within_radius(src, dst, r)
        assert (pnative.count_pairs_within_radius(src, dst, r)
                == jnative.count_pairs_within_radius(src, dst, r))
    assert pnative.count_pairs_within_radius(src[:0], dst, 0.1) == 0


@pytest.mark.parametrize("voxel", [0.025, 0.3])
def test_voxelize_np_output_is_unchanged(voxel):
    """With the library, voxelize_np gives what it gave before it called
    it: floor(x * (1/voxel)) in f32 and np.unique's first occurrences, on
    points that lie on cell boundaries too; without it, the JAX package's
    fallback."""
    xyz = _cloud(1, voxel)
    inv = np.float32(1.0) / np.float32(voxel)
    v = np.floor(xyz * inv).astype(np.int32)
    _, sel = np.unique(v, axis=0, return_index=True)
    sel = np.sort(sel)
    assert pnative.have_native()
    c, s = voxelize_np(xyz, voxel)
    np.testing.assert_array_equal(s, sel)
    np.testing.assert_array_equal(c, v[sel])
    assert (np.floor(xyz / voxel) != np.floor(xyz * inv)).any()
    c0, s0 = voxelize_np(xyz[:0], voxel)
    assert c0.shape == (0, 3) and s0.shape == (0,)
