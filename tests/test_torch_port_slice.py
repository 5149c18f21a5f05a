"""Port parity, the whole slice: the JAX chain that ``bench.py:351-400`` times
(quantize_grid → make_pyramid_fn → model.apply → sample_keypoints_segment →
register_kp) against ``PairRegistrar`` on the CPU, on a small synthetic pair
with carried weights and the JAX draws injected. f32 compute, so the
descriptors agree to 1e-4 and every integer (voxels, maps, keypoints, NN
indices, inliers) must be equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data.synthetic import synthetic_pair as jax_synthetic_pair
from imfnet_tpu.eval import extract as jx
from imfnet_tpu.eval.registration import (make_keypoint_registration,
                                          sample_keypoints_segment)
from imfnet_tpu.match.nn import nn_auto as jax_nn_auto
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.grid import GridSpec, quantize_grid
from imfnet_tpu.train.step import make_pyramid_fn

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.eval import extract as tx
from imfnet_tpu_torch.match.nn import nn_auto
from imfnet_tpu_torch.pipeline import PairRegistrar, bench_config
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

K = 400          # keypoints per fragment
H = 12500        # hypotheses: one block of the default size
HW = (24, 32)


@pytest.mark.parametrize("seed,n_points", [(0, 3000), (5, 8000)])
def test_synthetic_pair_same_arrays(seed, n_points):
    a = jax_synthetic_pair(np.random.RandomState(seed), n_points=n_points,
                           image_hw=HW)
    b = synthetic_pair(np.random.RandomState(seed), n_points=n_points,
                       image_hw=HW)
    for name in ("coords0", "xyz0", "feats0", "coords1", "xyz1", "feats1",
                 "image0", "image1", "T_gt"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("n", [5000, (1 << 17) + 3, (1 << 20) + 10])
def test_extract_helpers_match_jax(n):
    """Raw-point buckets (with the subsampling fallback past the largest)
    and the extent bucket, with and without smaller extent buckets."""
    rng = np.random.RandomState(n % 97)
    xyz = (rng.rand(n, 3) * np.array([1.0, 2.0, 5.0])).astype(np.float32)
    a, na = jx.pad_points_bucketed(xyz)
    b, nb = tx.pad_points_bucketed(xyz)
    assert na == nb and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert tx.RAW_BUCKETS == jx.RAW_BUCKETS
    assert tx.DEFAULT_BUCKETS == jx.DEFAULT_BUCKETS
    for buckets in (None, ((64, 64, 64), (128, 128, 256))):
        kw = dict(grid_extent_buckets=buckets)
        assert tx.pick_extent(b, nb, 0.025, threedmatch_config(**kw)) == \
            jx.pick_extent(a, na, 0.025, jax_config(**kw))
    assert tx.pick_extent(b, nb, 0.005, threedmatch_config()) is None


def _jax_chain(pair, cfg):
    """bench.py's chain at f32 compute, returning every intermediate."""
    raw0, n0 = jx.pad_points_bucketed(pair.xyz0)
    raw1, n1 = jx.pad_points_bucketed(pair.xyz1)
    e0 = jx.pick_extent(raw0, n0, cfg.voxel_size, cfg)
    e1 = jx.pick_extent(raw1, n1, cfg.voxel_size, cfg)
    extent = tuple(cfg.grid_extent) if e0 is None or e1 is None else max(e0, e1)
    spec = GridSpec(extent=extent, num_batches=2)
    b0, b1 = len(raw0), len(raw1)
    xyz = jnp.asarray(np.concatenate([raw0, raw1]))
    bidx = jnp.asarray(np.r_[np.zeros(b0, np.int32), np.ones(b1, np.int32)])
    valid = np.zeros(b0 + b1, bool)
    valid[:n0] = True
    valid[b0:b0 + n1] = True
    ones = jnp.ones((b0 + b1, 1), jnp.float32)

    def quant(n_out):
        return jax.jit(lambda x: quantize_grid(
            x, ones, jnp.asarray(valid), cfg.voxel_size, n_out, spec,
            batch_index=bidx))(xyz)

    n_vox = int(quant(2 * 32768)[0].num_valid)
    n_pad = next((2 * b for b in jx.DEFAULT_BUCKETS if 2 * b >= n_vox), 2 * 32768)
    sv, _, xyz_down = quant(n_pad)
    pyr = jax.jit(make_pyramid_fn(cfg, n_pad, num_batches=2, extent=extent))(
        sv.coords, sv.num_valid)
    images = jnp.asarray(np.stack([pair.image0, pair.image1]))
    model = jax_load_model(cfg.model)(
        in_channels=1, out_channels=cfg.model_n_out,
        conv1_kernel_size=cfg.conv1_kernel_size,
        normalize_feature=cfg.normalize_feature, compute_dtype=jnp.float32,
        conv1_occupancy=True)
    variables = jax.jit(lambda s, p, i: model.init(
        jax.random.PRNGKey(0), s, p, i, train=False))(sv, pyr, images)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rng = np.random.RandomState(9)
    # non-trivial running statistics: var leaves start at 1, mean leaves at 0
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim and v[0] == 1
                   else rng.randn(*v.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    feats = jax.jit(lambda s, p, i: model.apply(variables, s, p, i, train=False))(
        sv, pyr, images)

    n0v = jnp.sum((sv.coords[:, 0] == 0) & (jnp.arange(n_pad) < sv.num_valid))
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(3), 3)
    i0, ok0 = sample_keypoints_segment(k0, 0, n0v, K, n_pad)
    i1, ok1 = sample_keypoints_segment(k1, n0v, sv.num_valid - n0v, K, n_pad)
    kp0, kd0 = xyz_down[i0], feats[i0]
    kp1, kd1 = xyz_down[i1], feats[i1]
    register_kp = make_keypoint_registration(
        voxel_size=cfg.voxel_size, ransac_n=cfg.ransac_n, num_hypotheses=H,
        inlier_thresh=cfg.inlier_thresh)
    out = register_kp(k2, kp0, kd0, ok0, kp1, kd1, ok1,
                      jnp.asarray(pair.T_gt), jnp.eye(6, dtype=jnp.float32))
    draws = dict(
        u=(np.asarray(jax.random.uniform(k0, (n_pad,))),
           np.asarray(jax.random.uniform(k1, (n_pad,)))),
        samples=np.stack([np.asarray(jax.random.randint(
            kb, (H, cfg.ransac_n), 0, max(int(ok0.sum()), 1)))
            for kb in jax.random.split(k2, 1)]))
    return dict(sv=sv, xyz_down=xyz_down, pyr=pyr, feats=feats, i0=i0, i1=i1,
                nn01=jax_nn_auto(kd0, kd1, ok1)[0], out=out,
                variables=variables, draws=draws)


@pytest.fixture(scope="module")
def chain():
    pair = synthetic_pair(np.random.RandomState(2), n_points=6000, image_hw=HW)
    # a 6000-point cloud is sparser than a fragment: its coarse levels
    # overflow the bench's divisors (1, 3, 8, 20), which PairRegistrar refuses
    div = (1, 2, 4, 8)
    ref = _jax_chain(pair, jax_config(level_capacity_divisors=div,
                                      num_rand_keypoints=K))
    cfg = bench_config().replace(compute_dtype="float32", num_rand_keypoints=K,
                                 ransac_max_iteration=H, level_capacity_divisors=div)
    reg = PairRegistrar(cfg, device="cpu",
                        state_dict=state_dict_from_flax(ref["variables"]))
    pb = reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1)
    q = reg.quantize(pb)
    pyr = reg.pyramid(q)
    feats = reg.forward(q, pyr, pb.images)
    u0, u1 = (torch.tensor(u) for u in ref["draws"]["u"])
    out = reg.match(q, feats, pair.T_gt, np.eye(6), keypoint_u=(u0, u1),
                    samples=torch.from_numpy(ref["draws"]["samples"]))
    # the chain as one call gives the same result as the stages
    out_call = reg(pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt,
                   np.eye(6), keypoint_u=(u0, u1),
                   samples=torch.from_numpy(ref["draws"]["samples"]))
    return dict(ref=ref, q=q, pyr=pyr, feats=feats, out=out, out_call=out_call,
                reg=reg)


def test_slice_integer_tables_equal(chain):
    ref, q, pyr = chain["ref"], chain["q"], chain["pyr"]
    assert q.sv.n_padded == ref["sv"].coords.shape[0]
    assert int(q.sv.num_valid) == int(ref["sv"].num_valid)
    np.testing.assert_array_equal(q.sv.coords.numpy(), np.asarray(ref["sv"].coords))
    np.testing.assert_array_equal(q.xyz_down.numpy(), np.asarray(ref["xyz_down"]))
    np.testing.assert_array_equal(pyr.k5_l0.numpy(), np.asarray(ref["pyr"].k5_l0))
    for lt, lj in zip(pyr.levels, ref["pyr"].levels):
        assert int(lt.num_valid) == int(lj.num_valid)
        for name in ("coords", "k3_same", "down", "up"):
            a, b = getattr(lt, name), getattr(lj, name)
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_slice_descriptors_and_matches(chain):
    ref = chain["ref"]
    np.testing.assert_allclose(chain["feats"].numpy(), np.asarray(ref["feats"]),
                               rtol=0, atol=1e-4)
    # same keypoints from the same keys, the same NN indices
    u0, u1 = (torch.tensor(u) for u in ref["draws"]["u"])
    n_pad = chain["q"].sv.n_padded
    i0 = torch.sort(torch.where(torch.arange(n_pad) < chain["q"].n0, u0,
                                torch.full_like(u0, 2.0))).indices[:K]
    np.testing.assert_array_equal(i0.numpy(), np.asarray(ref["i0"]))
    i1 = np.asarray(ref["i1"])
    kd0, kd1 = chain["feats"][i0], chain["feats"][torch.tensor(i1).long()]
    ok1 = torch.arange(K) < min(K, int(chain["q"].sv.num_valid - chain["q"].n0))
    nn01 = nn_auto(kd0, kd1, ok1)[0]
    np.testing.assert_array_equal(nn01.numpy(), np.asarray(ref["nn01"]))


def test_slice_registration_equal(chain):
    a, b = chain["out"], chain["ref"]["out"]
    assert set(a) == set(b)
    assert bool(a["accepted"]) == bool(b["accepted"])
    np.testing.assert_allclose(a["transformation"].numpy(),
                               np.asarray(b["transformation"]), rtol=0, atol=1e-4)
    for k in ("fitness", "ir", "num_inliers", "inlier_ratio_mutual", "rr"):
        assert float(a[k]) == pytest.approx(float(b[k]), abs=1e-6), k
    for k in ("rre_raw", "rte_raw"):
        assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-3, abs=1e-3), k
    for k, v in chain["out_call"].items():
        assert torch.equal(v, a[k]), k
