"""Port parity, the 3DMatch benchmark path: ``evaluate`` of both packages on
the synthetic benchmark of ``tests/test_benchmark_eval.py`` with the JAX
RANSAC draws injected (per-pair metrics, summary, CSVs, keypoint caches),
the replay of saved keypoints, ``generate_descriptors`` on a PLY scene, and
``compare_methods`` / ``convert_external_descriptors``."""
import csv
import json
import os
import os.path as osp

import numpy as np
import jax
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.eval import compare as jcmp
from imfnet_tpu.eval import threedmatch as jtm
from imfnet_tpu.geom.transforms import sample_random_trans

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.eval import compare as tcmp
from imfnet_tpu_torch.eval import threedmatch as ttm
from imfnet_tpu_torch.eval.extract import pad_points_bucketed, pick_extent
from imfnet_tpu_torch.eval.registration import make_keypoint_registration
from imfnet_tpu_torch.geom.ply import read_ply, write_ply
from imfnet_tpu_torch.train.trainer import build_model_from_config

SCENE, SEQ = "synthetic-scene", "seq-01"
N_PTS, N_DESC = 600, 16
CFG = dict(num_rand_keypoints=256, ransac_max_iteration=4096, ransac_n=3)
HYPO_BLOCK = 12500
METRIC_ATOL = 1e-4    # rte, ir and the pose: f32 fits, sums in another order
# RRE in degrees is arccos((trace(R) - 1) / 2) in f32: at an exact fit the
# argument sits within a few f32 steps of 1, and one step below 1 is 0.028°,
# so two poses 1e-7 apart give RREs of 0 and a few hundredths of a degree
RRE_ATOL = 0.1
COUNT_ATOL = 1e-6     # num_inliers, inlier_ratio: RANSAC plays no part in them


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_benchmark(bench_dir, poses):
    scene_bench = bench_dir / SCENE
    os.makedirs(scene_bench)
    with open(scene_bench / "gt.log", "w") as flog, open(scene_bench / "gt.info", "w") as finfo:
        for i, j in [(0, 1), (1, 2)]:
            T = np.linalg.inv(poses[i]) @ poses[j]
            flog.write(f"{i} {j} 3\n")
            for r in range(4):
                flog.write("\t".join(f"{v:.12f}" for v in T[r]) + "\n")
            finfo.write(f"{i} {j} 3\n")
            cov = np.eye(6) * 400.0   # tight acceptance scale
            for r in range(6):
                finfo.write("\t".join(f"{v:.6f}" for v in cov[r]) + "\n")


def synthetic_benchmark(tmp_path, methods=("TEST",), seed=3):
    """The fixture of tests/test_benchmark_eval.py: three fragments with
    known rigid relations whose shared points share descriptors, gt.log and
    gt.info for pairs (0, 1) and (1, 2); a method other than the first gets
    random descriptors. Returns (descriptor roots by method, benchmark dir,
    the fragments' world points and descriptors)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(N_PTS * 2, 3).astype(np.float32) * 2.0
    frag_world = [base[:N_PTS], base[N_PTS // 2: N_PTS // 2 + N_PTS], base[N_PTS:]]
    descs_world = rng.randn(N_PTS * 2, N_DESC).astype(np.float32)
    descs_world /= np.linalg.norm(descs_world, axis=1, keepdims=True)
    frag_desc = [descs_world[:N_PTS], descs_world[N_PTS // 2: N_PTS // 2 + N_PTS],
                 descs_world[N_PTS:]]
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(2):
        poses.append(sample_random_trans(base, rng).astype(np.float32))
    roots = {}
    for mi, method in enumerate(methods):
        root = tmp_path / f"descs_{method}"
        os.makedirs(root / SCENE / SEQ)
        for k in range(3):
            inv = np.linalg.inv(poses[k])
            local = frag_world[k] @ inv[:3, :3].T + inv[:3, 3]
            feat = frag_desc[k] if mi == 0 else rng.randn(N_PTS, N_DESC).astype(np.float32)
            np.savez_compressed(root / SCENE / SEQ / f"cloud_bin_{k}.npz",
                                points=local, xyz=local, feature=feat)
        roots[method] = str(root)
    bench_dir = tmp_path / "benchmarks"
    _write_benchmark(bench_dir, poses)
    return roots, str(bench_dir), frag_world, frag_desc


def jax_samples(key, n_valid, num_hypotheses, hypo_block, ransac_n):
    """The draws imfnet_tpu/match/ransac.py makes: one key per block,
    randint in [0, max(n_valid, 1))."""
    n_blocks = -(-num_hypotheses // hypo_block)
    keys = jax.random.split(key, n_blocks)
    return np.stack([np.asarray(jax.random.randint(
        k, (hypo_block, ransac_n), 0, max(n_valid, 1))) for k in keys])


def jax_draws_register(config, inlier_thresh):
    """A port ``register`` that gives pair k the RANSAC samples the JAX
    evaluator draws from PRNGKey(k)."""
    register_kp = make_keypoint_registration(
        voxel_size=config.voxel_size, ransac_n=config.ransac_n,
        num_hypotheses=config.ransac_max_iteration, inlier_thresh=inlier_thresh)

    def register(k, kp0, kd0, ok0, kp1, kd1, ok1, T_gt, cov, *, swap):
        n_valid = int((ok1 if swap else ok0).sum())
        s = jax_samples(jax.random.PRNGKey(k), n_valid, config.ransac_max_iteration,
                        HYPO_BLOCK, config.ransac_n)
        return register_kp(kp0, kd0, ok0, kp1, kd1, ok1, T_gt, cov,
                           samples=torch.from_numpy(s), swap=swap)

    return register


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    roots, bench_dir, _, _ = synthetic_benchmark(tmp)
    cfg = threedmatch_config(**CFG)
    out = {}
    out["jax"] = jtm.evaluate(jax_config(**CFG), roots["TEST"], str(tmp / "jax"), bench_dir,
                              desc_type="TEST", scenes=[SCENE], seq_name=SEQ)
    out["port"] = ttm.evaluate(cfg, roots["TEST"], str(tmp / "port"), bench_dir,
                               desc_type="TEST", scenes=[SCENE], seq_name=SEQ,
                               device="cpu",
                               register=jax_draws_register(cfg, cfg.inlier_thresh))
    return out, tmp, roots, bench_dir


def _results(root):
    with open(osp.join(root, "TEST", f"{SCENE}-{SEQ}-0.10.json")) as f:
        return json.load(f)["register_results"]


def test_keypoint_caches_hold_equal_arrays(evaluated):
    _, tmp, _, _ = evaluated
    names = sorted(os.listdir(tmp / "jax" / "TEST_keypoints"))
    assert names == sorted(os.listdir(tmp / "port" / "TEST_keypoints")) == [
        f"{SCENE}_{SEQ}_0_1_keypoints.npz", f"{SCENE}_{SEQ}_1_2_keypoints.npz"]
    for name in names:
        a = np.load(tmp / "jax" / "TEST_keypoints" / name)
        b = np.load(tmp / "port" / "TEST_keypoints" / name)
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])


def test_per_pair_metrics_equal_jax(evaluated):
    _, tmp, _, _ = evaluated
    ja, po = _results(tmp / "jax"), _results(tmp / "port")
    assert len(ja) == len(po) == 2
    for a, b in zip(ja, po):
        assert (a["frag1"], a["frag2"], a["gt_flag"]) == (b["frag1"], b["frag2"], b["gt_flag"])
        for k in ("num_inliers", "inlier_ratio"):
            assert b[k] == pytest.approx(a[k], abs=COUNT_ATOL), k
        assert b["rr"] == a["rr"] == 1.0
        for k in ("rte", "ir", "rte_raw"):
            assert b[k] == pytest.approx(a[k], abs=METRIC_ATOL), k
        for k in ("rre", "rre_raw"):
            assert b[k] == pytest.approx(a[k], abs=RRE_ATOL), k
        np.testing.assert_allclose(b["transformation"], a["transformation"], rtol=0,
                                   atol=METRIC_ATOL)
        np.testing.assert_array_equal(b["T_gt"], a["T_gt"])


def test_summary_and_csvs_equal_jax(evaluated):
    out, tmp, _, _ = evaluated
    assert set(out["port"]) == set(out["jax"])
    for k in ("registration_recall", "FMR", "FMR_std", "threshes", "num_pairs", "benchmark"):
        assert out["port"][k] == out["jax"][k], k
    for k in ("RTE", "inlier_ratio"):
        assert out["port"][k] == pytest.approx(out["jax"][k], abs=METRIC_ATOL), k
    assert out["port"]["RRE"] == pytest.approx(out["jax"]["RRE"], abs=RRE_ATOL)
    with open(tmp / "jax" / "TEST-summary.json") as a, open(tmp / "port" / "TEST-summary.json") as b:
        assert json.load(a).keys() == json.load(b).keys()
    for name in ("TEST-metrics-0.10.csv", "TEST-recall-curve.csv"):
        with open(tmp / "jax" / name) as a, open(tmp / "port" / name) as b:
            assert a.read() == b.read(), name
    assert osp.exists(tmp / "port" / "TEST" / f"{SCENE}-{SEQ}-0.10.txt")


def test_replay_of_saved_keypoints_reproduces_the_run(evaluated):
    out, tmp, roots, bench_dir = evaluated
    cfg = threedmatch_config(**CFG)
    again = ttm.evaluate(cfg, roots["TEST"], str(tmp / "port2"), bench_dir,
                         desc_type="TEST", scenes=[SCENE], seq_name=SEQ, device="cpu",
                         keypoints_root=str(tmp / "port" / "TEST_keypoints"),
                         use_saved_keypoints=True,
                         register=jax_draws_register(cfg, cfg.inlier_thresh))
    for k in ("registration_recall", "inlier_ratio", "RRE", "RTE", "FMR"):
        assert again[k] == out["port"][k], k
    # the port's own draws, generator seeded with the pair index: a run is
    # repeatable, and the synthetic pairs register
    own = [ttm.evaluate(cfg, roots["TEST"], str(tmp / f"own{i}"), bench_dir,
                        desc_type="TEST", scenes=[SCENE], seq_name=SEQ, device="cpu")
           for i in range(2)]
    assert own[0] == own[1] and own[0]["registration_recall"] == 1.0


def test_num_devices_other_than_one_raises(tmp_path):
    """More than one device needs this process to be a rank of as many
    (``mesh``); the sharded run is in tests/test_torch_port_parallel_eval.py."""
    from imfnet_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="ranks"):
        ttm.generate_descriptors(None, threedmatch_config(), str(tmp_path), str(tmp_path),
                                 num_devices=2)
    with pytest.raises(ValueError, match="ranks"):
        ttm.generate_descriptors(None, threedmatch_config(), str(tmp_path), str(tmp_path),
                                 num_devices=2, mesh=Mesh(3, 0, "cpu", None, "gloo"))


def test_generate_descriptors_writes_npz(tmp_path):
    """PLY scene → bucketed extraction → .npz{points, xyz, feature}; the
    2 000-point fragments exceed the smallest raw bucket and roll up to the
    next with every point kept."""
    rng = np.random.RandomState(0)
    config = threedmatch_config(conv1_kernel_size=3, model_n_out=16, compute_dtype="float32",
                                grid_extent=(128, 128, 128), image_H=24, image_W=32)
    scene_dir = tmp_path / "pcloud" / "toy-scene" / "seq-01"
    os.makedirs(scene_dir)
    for k in range(2):
        pts = (rng.rand(2000, 3) * (1.5 if k == 0 else 4.0)).astype(np.float32)
        write_ply(str(scene_dir / f"cloud_bin_{k}.ply"), pts,
                  colors=rng.rand(2000, 3))
    model = build_model_from_config(config, eval_fast=True).eval()
    out_root = tmp_path / "descs"
    stats = ttm.generate_descriptors(model, config, str(tmp_path / "pcloud"), str(out_root),
                                     scenes=["toy-scene"], raw_buckets=(1024, 2048))
    assert stats["count"] == 2 and stats["avg_time"] == pytest.approx(stats["all_time"] / 2)
    for k, extent in enumerate([(128, 128, 128), None]):     # the second is 4 m wide
        ply = read_ply(str(scene_dir / f"cloud_bin_{k}.ply"))
        raw, n = pad_points_bucketed(ply["points"].astype(np.float32), (1024, 2048))
        assert pick_extent(raw, n, config.voxel_size, config) == extent
        assert ply["colors"].shape == (2000, 3)
        d = np.load(out_root / "toy-scene" / "seq-01" / f"cloud_bin_{k}.npz")
        assert set(d.files) == {"points", "xyz", "feature"}
        np.testing.assert_array_equal(d["points"], ply["points"].astype(np.float32))
        assert d["feature"].shape[1] == config.model_n_out
        assert len(d["xyz"]) == len(d["feature"]) > 100
        np.testing.assert_allclose(np.linalg.norm(d["feature"], axis=1), 1.0, rtol=1e-4)
        raw_keys = {tuple(v) for v in np.floor(d["points"] / config.voxel_size).astype(np.int64)}
        desc_keys = {tuple(v) for v in np.floor(d["xyz"] / config.voxel_size).astype(np.int64)}
        assert raw_keys <= desc_keys, f"{len(raw_keys - desc_keys)} raw voxels missing"
    # a second call finds every .npz written and extracts nothing
    assert ttm.generate_descriptors(model, config, str(tmp_path / "pcloud"), str(out_root),
                                    scenes=["toy-scene"])["count"] == 0


def test_compare_methods_and_convert_equal_jax(tmp_path):
    roots, bench_dir, frag_world, frag_desc = synthetic_benchmark(tmp_path, ("GOOD", "BAD"))
    cfg = threedmatch_config(**CFG)
    js = jcmp.compare_methods(roots, bench_dir, str(tmp_path / "jcmp"), jax_config(**CFG),
                              scenes=[SCENE], seq_name=SEQ)
    ts = tcmp.compare_methods(roots, bench_dir, str(tmp_path / "tcmp"), cfg,
                              scenes=[SCENE], seq_name=SEQ, device="cpu",
                              register=jax_draws_register(cfg, 0.1))
    assert ts["per_method"]["GOOD"]["rr"] == 1.0 and ts["per_method"]["BAD"]["rr"] < 0.5
    assert ts["per_method"] == js["per_method"]
    assert ts["select"] == js["select"] and len(ts["select"]) >= 1
    # comparison.csv: the same rows and columns; rr equal, the errors
    # (rounded to 4 places) within their tolerances
    with open(js["csv"]) as a, open(ts["csv"]) as b:
        ra, rb = list(csv.reader(a)), list(csv.reader(b))
    assert ra[0] == rb[0] and len(ra) == len(rb) == 3
    for x, y in zip(ra[1:], rb[1:]):
        assert x[:3] == y[:3]
        for col, name in enumerate(ra[0][3:], start=3):
            tol = {"rr": 0, "rre": RRE_ATOL, "rte": 2e-4}[name.rsplit("_", 1)[1]]
            assert float(y[col]) == pytest.approx(float(x[col]), abs=tol), name
    assert sorted(os.listdir(ts["result_dir"])) == sorted(os.listdir(js["result_dir"]))
    assert sorted(os.listdir(ts["select_dir"])) == sorted(os.listdir(js["select_dir"]))
    assert ts["views"] == js["views"]
    for suffix in ("-before.ply", "-after.ply"):
        a = read_ply(str(tmp_path / "jcmp" / "select_views" / (js["views"][0] + suffix)))
        b = read_ply(str(tmp_path / "tcmp" / "select_views" / (ts["views"][0] + suffix)))
        np.testing.assert_array_equal(b["colors"], a["colors"])
        np.testing.assert_allclose(b["points"], a["points"], rtol=0, atol=1e-3)
    txt = open(osp.join(ts["select_dir"], os.listdir(ts["select_dir"])[0])).read()
    assert "GOOD---rte:" in txt and "BAD---rte:" in txt and "Ground Truth,T:" in txt

    # external conversion (the spinnet_desc reformat)
    ext_desc, kp_root = tmp_path / "ext" / SCENE, tmp_path / "kp" / SCENE
    os.makedirs(ext_desc)
    os.makedirs(kp_root)
    np.save(ext_desc / "cloud_bin_0.desc.SpinNet.bin.npy", frag_desc[0])
    np.save(ext_desc / "cloud_bin_1.desc.SpinNet.bin.npy", frag_desc[1])
    np.save(kp_root / "cloud_bin_0_keypts.npy", frag_world[0])
    outs = [m.convert_external_descriptors(str(tmp_path / "ext"), str(tmp_path / "kp"),
                                           str(tmp_path / f"npz_{i}"))
            for i, m in enumerate((jcmp, tcmp))]
    assert [osp.relpath(p, tmp_path / "npz_1") for p in outs[1]] == \
        [osp.relpath(p, tmp_path / "npz_0") for p in outs[0]] == [f"{SCENE}/{SEQ}/cloud_bin_0.npz"]
    a, b = np.load(outs[0][0]), np.load(outs[1][0])
    assert a.files == b.files == ["xyz", "feature"]
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k])
