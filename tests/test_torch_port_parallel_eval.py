"""The port's sharded evaluation on two gloo ranks on the CPU, after
``tests/test_parallel_eval.py`` and ``tests/test_parallel.py``:

- sharded ``generate_descriptors`` against the JAX package's with
  ``num_devices=2`` (two of the eight virtual CPU devices of
  ``conftest.py``) and against the port's serial run, with the
  ``coarse_levels_fit`` re-extraction at a pad whose coarse levels overflow;
- ``make_sharded_extractor`` against the one-fragment extractor, each rank
  extracting only its own fragments;
- sharded ``evaluate_kitti`` against the serial run, each rank loading only
  its own pairs of the test loader, a rejected pair included;
- ``make_parallel_registration`` and ``make_parallel_eval_forward``
  against their serial functions.
The ranks split the items, so every result is the serial computation's."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from imfnet_tpu.eval.threedmatch import generate_descriptors as jax_generate_descriptors
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train.step import level_capacities as jax_level_capacities

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.datasets import PairLoader, SyntheticPairDataset
from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.eval import threedmatch as ttm
from imfnet_tpu_torch.eval.extract import make_extractor
from imfnet_tpu_torch.eval.kitti import evaluate_kitti
from imfnet_tpu_torch.eval.registration import make_keypoint_registration
from imfnet_tpu_torch.geom.ply import write_ply
from imfnet_tpu_torch.geom.transforms import sample_random_trans
from imfnet_tpu_torch.parallel import dp
from imfnet_tpu_torch.parallel.mesh import Mesh, spawn_ranks
from imfnet_tpu_torch.train.step import forward_pair
from imfnet_tpu_torch.train.trainer import build_model_from_config
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

from test_torch_port_train import _one_torch_thread  # noqa: F401

CPU2 = ["cpu", "cpu"]
SMALL = dict(batch_size=1, conv1_kernel_size=3, model_n_out=16, max_points=512, voxel_size=0.05,
             compute_dtype="float32")
SCENE = "toy-scene"


@pytest.fixture(scope="module")
def models():
    """The JAX model and variables of tests/test_parallel_eval.py and the
    port's inference model with the same weights."""
    jcfg = jax_config(**SMALL)
    jmodel = jax_load_model(jcfg.model)(
        in_channels=1, out_channels=16, conv1_kernel_size=3, normalize_feature=True,
        bn_momentum=jcfg.bn_momentum, compute_dtype=jnp.float32)
    b = jax_synthetic_batch(np.random.RandomState(0), batch_size=1, n_points=200, n_pad=512,
                            image_hw=(120, 160))
    pyr = jax_build_pyramid(b.coords0, b.n0, conv1_kernel_size=3,
                            level_capacity=jax_level_capacities(512))
    variables = jmodel.init(jax.random.PRNGKey(0), JaxSparseVoxels(b.coords0, b.feats0, b.n0),
                            pyr, b.image0, train=False)
    cfg = threedmatch_config(**SMALL)
    model = build_model_from_config(cfg, eval_fast=True)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                      dict(variables))))
    return jcfg, jmodel, variables, cfg, model.eval()


def _npz(out, k):
    return np.load(out / SCENE / "seq-01" / f"cloud_bin_{k}.npz")


def test_generate_descriptors_sharded_matches_jax_and_serial(tmp_path, models):
    """Five fragments on two ranks: rank 0 takes 0, 2, 4 and rank 1 takes
    1, 3. At n_pad 2048 every fragment fits; at 512 the dispersed points
    overflow the coarse capacities and each fragment is extracted again
    through the bucketed extractor, never truncated."""
    jcfg, jmodel, variables, cfg, model = models
    jcfg = jcfg.replace(grid_extent=(128, 128, 128))
    cfg = cfg.replace(grid_extent=(128, 128, 128))
    rng = np.random.RandomState(3)
    scene_dir = tmp_path / "pcloud" / SCENE / "seq-01"
    os.makedirs(scene_dir)
    for k in range(5):
        write_ply(str(scene_dir / f"cloud_bin_{k}.ply"),
                  (rng.rand(400 + 40 * k, 3) * 1.2).astype(np.float32))
    pcloud = str(tmp_path / "pcloud")
    kw = dict(scenes=[SCENE], raw_buckets=(512, 1024))

    stats = jax_generate_descriptors(jmodel, variables, jcfg, pcloud, str(tmp_path / "jax"),
                                     num_devices=2, sharded_n_pad=2048, **kw)
    assert stats["count"] == 5
    serial = ttm.generate_descriptors(model, cfg, pcloud, str(tmp_path / "serial"), **kw)
    assert serial["count"] == 5
    runs = {}
    for n_pad in (2048, 512):
        out = tmp_path / f"sharded{n_pad}"
        ranks = spawn_ranks(dp.call_with_mesh, CPU2, (
            ttm.generate_descriptors, (model, cfg, pcloud, str(out)),
            dict(num_devices=2, sharded_n_pad=n_pad, **kw)))
        assert ranks[0] == ranks[1]
        assert ranks[0]["count"] == 5 and ranks[0]["num_devices"] == 2
        assert ranks[0]["avg_time"] == pytest.approx(ranks[0]["all_time"] / 5)
        runs[n_pad] = out
    for k in range(5):
        want, ser = _npz(tmp_path / "jax", k), _npz(tmp_path / "serial", k)
        for got in (_npz(runs[2048], k), _npz(runs[512], k)):
            assert set(got.files) == {"points", "xyz", "feature"}
            np.testing.assert_array_equal(got["points"], ser["points"])
            np.testing.assert_array_equal(got["xyz"], ser["xyz"])
            np.testing.assert_allclose(got["feature"], ser["feature"], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got["xyz"], want["xyz"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got["feature"], want["feature"], rtol=1e-4, atol=1e-5)
    # the 512 pad took the re-extraction: no fragment fits it whole
    from imfnet_tpu_torch.eval.extract import pad_points_bucketed
    from imfnet_tpu_torch.geom.ply import read_ply

    one = make_extractor(model, config=cfg, n_pad=512)
    for k in range(5):
        raw, n = pad_points_bucketed(read_ply(str(scene_dir / f"cloud_bin_{k}.ply"))["points"],
                                     (512, 1024))
        _, _, nv = one(raw, n, np.zeros((1, cfg.image_H, cfg.image_W, 3), np.float32))
        assert int(nv) >= 512 or not bool(one.fits)
    with pytest.raises(ValueError, match="ranks"):
        ttm.generate_descriptors(model, cfg, pcloud, str(tmp_path / "x"), num_devices=2, **kw)


def test_sharded_extractor_matches_single_device(models):
    _, _, _, cfg, model = models
    D, n_raw, n_pad = 5, 1024, 512
    rng = np.random.RandomState(1)
    raws = np.zeros((D, n_raw, 3), np.float32)
    ns = rng.randint(300, 900, size=D).astype(np.int32)
    for d in range(D):
        raws[d, :ns[d]] = rng.rand(ns[d], 3).astype(np.float32) * 1.2
    images = rng.rand(D, 120, 160, 3).astype(np.float32)
    # the extractor runs no collective: each rank's record in this process,
    # given only that rank's fragments and None for the others
    ranks = [dp.make_sharded_extractor(model, cfg, Mesh(2, r, torch.device("cpu"), None, "gloo"),
                                       n_pad=n_pad)(
        [(d, (raws[d], ns[d], images[d][None]) if d % 2 == r else None) for d in range(D)])
        for r in range(2)]
    assert sorted(ranks[0]) == [0, 2, 4] and sorted(ranks[1]) == [1, 3]
    got = {**ranks[0], **ranks[1]}
    single = make_extractor(model, config=cfg, n_pad=n_pad)
    for d in range(D):
        xd_s, f_s, nv_s, fits = got[d]
        assert fits.dtype == torch.bool and fits.dim() == 0
        xd, f, nv = single(raws[d], int(ns[d]), images[d][None])
        nv = int(nv)
        assert nv == int(nv_s) > 0
        assert bool(fits) == bool(single.fits)
        np.testing.assert_array_equal(xd_s[:nv].numpy(), xd[:nv].numpy())
        np.testing.assert_allclose(f_s[:nv].numpy(), f[:nv].numpy(), rtol=1e-5, atol=1e-6)


def _pair_batches(cfg, n):
    rng = np.random.RandomState(2)
    return [synthetic_batch(rng, batch_size=1, n_points=200, n_pad=cfg.max_points,
                            image_hw=(120, 160), device="cpu") for _ in range(n)]


class RejectingPairs(SyntheticPairDataset):
    """Synthetic pairs, pair 2 rejected as KITTI rejects one with too few
    ground-truth matches (a ValueError the loader counts)."""

    def __getitem__(self, idx):
        if idx == 2:
            raise ValueError("fewer than 1000 ground-truth matches")
        return super().__getitem__(idx)


def test_evaluate_kitti_sharded_matches_single(models):
    """Six pairs of a test loader on two ranks, pair 2 rejected: each rank
    loads its own pairs (rank 0 pairs 0 and 4, rank 1 pairs 1, 3 and 5),
    and the gathered summary, the rejection counted, is the serial one,
    the draws of pair i seeded with i on either side."""
    _, _, _, cfg, model = models
    cfg = cfg.replace(ransac_max_iteration=512, ransac_n=4)
    loader = PairLoader(RejectingPairs("test", cfg, length=6, n_points=200,
                                       random_rotation=False, random_scale=False),
                        1, cfg.max_points, shuffle=False)
    serial = evaluate_kitti(model, cfg, loader)
    assert serial["num_pairs"] == 5 and serial["failed_loads"] == 1
    assert [len(loader.for_rank(r, 2)) for r in range(2)] == [3, 3]
    assert [b for b, _ in loader.for_rank(1, 2).numbered()] == [1, 3, 5]
    # in one pair of rank processes: rank 0 alone (the serial path), then both
    calls = [(dp.solo, (dp.call_with_mesh, (evaluate_kitti, (model, cfg, loader)))),
             (dp.call_with_mesh, (evaluate_kitti, (model, cfg, loader), dict(num_devices=2)))]
    ranks = [[out for out, _ in r] for r in spawn_ranks(dp.run_calls, CPU2, (calls,))]
    assert ranks[0][0] == serial and ranks[1][0] is None
    assert ranks[0][1] == ranks[1][1] == serial
    with pytest.raises(ValueError, match="ranks"):
        evaluate_kitti(model, cfg, loader, num_devices=2)


def test_parallel_registration_matches_single():
    D, K = 4, 128
    rng = np.random.RandomState(0)
    kp0s, kd0s, kp1s, kd1s, Ts = [], [], [], [], []
    for _ in range(D):
        src = rng.rand(K, 3).astype(np.float32) * 2
        T = sample_random_trans(src, rng).astype(np.float32)
        desc = rng.randn(K, 16).astype(np.float32)
        kp0s.append(src)
        kp1s.append(src @ T[:3, :3].T + T[:3, 3])
        kd0s.append(desc)
        kd1s.append(desc + rng.randn(K, 16).astype(np.float32) * 1e-3)
        Ts.append(np.linalg.inv(T))
    ok = torch.ones((D, K), dtype=torch.bool)
    args = ([7 * i for i in range(D)], torch.from_numpy(np.stack(kp0s)),
            torch.from_numpy(np.stack(kd0s)), ok, torch.from_numpy(np.stack(kp1s).astype(np.float32)),
            torch.from_numpy(np.stack(kd1s)), ok, torch.from_numpy(np.stack(Ts).astype(np.float32)),
            torch.eye(6).expand(D, 6, 6).contiguous())
    kw = dict(voxel_size=0.05, num_hypotheses=2048)
    ranks = spawn_ranks(dp.call_with_mesh, CPU2, (dp.make_parallel_registration, (), kw, args))
    out = ranks[0]
    assert out["rr"].shape == (D,)
    single = make_keypoint_registration(**kw)
    for d in range(D):
        ref = single(*(a[d] for a in args[1:]),
                     generator=torch.Generator().manual_seed(args[0][d]))
        for k, v in ref.items():
            assert torch.equal(out[k][d], v.cpu()), k
            assert torch.equal(ranks[1][k][d], v.cpu()), k


def test_parallel_eval_forward_matches_single(models):
    _, _, _, cfg, model = models
    batches = _pair_batches(cfg, 3)
    ranks = spawn_ranks(dp.call_with_mesh, CPU2, (
        dp.make_parallel_eval_forward, (), dict(model=model, config=cfg), (batches,)))
    f0s, f1s = ranks[0]
    assert len(f0s) == len(f1s) == 3
    for d in range(3):
        with torch.no_grad():
            r0, r1 = forward_pair(model, batches[d], train=False, config=cfg)
        assert torch.equal(f0s[d], r0) and torch.equal(f1s[d], r1)
