"""Port parity, the parts of training: batch collation, the positive search
(and the reference's fault there), batch-norm running statistics, the
optimizers and the learning-rate schedule, the IRLS pose fit, the validation
step and the weight map's inverse, against the JAX package on the same numpy
inputs and random draws. The JAX side runs un-jitted at a small size."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data import collate as jcollate
from imfnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from imfnet_tpu.match.irls import est_rigid_irls as jax_irls
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.models.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from imfnet_tpu.models.resnet import ResNetTrunk as JaxTrunk
from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train import state as jstate
from imfnet_tpu.train import step as jstep
from imfnet_tpu.train.validate import make_val_step as jax_make_val_step

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.match.irls import est_rigid_irls
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.models.layers import MaskedBatchNorm
from imfnet_tpu_torch.models.resnet import ResNetTrunk
from imfnet_tpu_torch.train.state import make_optimizer
from imfnet_tpu_torch.train.step import compute_correspondences
from imfnet_tpu_torch.train.validate import make_val_step
from imfnet_tpu_torch.utils.flax_weights import flax_from_state_dict, state_dict_from_flax

SMALL = dict(batch_size=2, conv1_kernel_size=3, model_n_out=16, num_pos_per_batch=128,
             num_hn_samples_per_batch=64, max_points=2048, compute_dtype="float32")
N_PAD = SMALL["max_points"]
RADIUS = 0.0375


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers a thread pool per process oversubscribes the cores,
    and its barriers then cost far more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tensor(a):
    return torch.tensor(np.asarray(a))


def _jax_model(cfg):
    return jax_load_model(cfg.model)(
        in_channels=1, out_channels=cfg.model_n_out, conv1_kernel_size=cfg.conv1_kernel_size,
        normalize_feature=cfg.normalize_feature, bn_momentum=cfg.bn_momentum,
        compute_dtype=jnp.float32)


def _port_model(cfg, variables):
    m = load_model(cfg.model)(in_channels=1, out_channels=cfg.model_n_out,
                              conv1_kernel_size=cfg.conv1_kernel_size,
                              compute_dtype=torch.float32, bn_momentum=cfg.bn_momentum)
    m.load_state_dict(state_dict_from_flax(variables), strict=True)
    return m


@pytest.fixture(scope="module")
def setup():
    """A two-pair batch on both sides with the positives the port's search
    finds, and flax variables for the small model."""
    jcfg = jax_config(use_grid_maps=False, **SMALL)
    cfg = threedmatch_config(**SMALL)
    jbatch = jax_synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=700,
                                 n_pad=N_PAD, image_hw=(24, 32))
    batch = synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=700,
                            n_pad=N_PAD, image_hw=(24, 32), device="cpu")
    pairs, ok = compute_correspondences(batch, RADIUS)
    batch = batch._replace(pairs=pairs, pair_valid=ok)
    jbatch = jbatch._replace(pairs=jnp.asarray(pairs.numpy()), pair_valid=jnp.asarray(ok.numpy()))
    model = _jax_model(jcfg)
    sv0 = JaxSparseVoxels(jbatch.coords0, jbatch.feats0, jbatch.n0)
    pyr0 = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, conv1_kernel_size=3, level_capacity=jstep.level_capacities(N_PAD)))(
            jbatch.coords0, jbatch.n0)
    variables = jax.jit(lambda s, p, i: model.init(jax.random.PRNGKey(0), s, p, i, train=False))(
        sv0, pyr0, jbatch.image0)
    return dict(jcfg=jcfg, cfg=cfg, jbatch=jbatch, batch=batch, jmodel=model,
                variables=_np(dict(variables)))


def _draws(key, sizes):
    keys = jax.random.split(key, len(sizes))
    return [_tensor(jax.random.uniform(k, (n,))) for k, n in zip(keys, sizes)]


# ---- data -------------------------------------------------------------------

def test_synthetic_batch_equals_jax(setup):
    jb, b = setup["jbatch"], setup["batch"]
    for name in ("coords0", "feats0", "n0", "image0", "coords1", "feats1", "n1", "image1",
                 "xyz0", "xyz1", "T_gt", "search_radius"):
        got, ref = getattr(b, name), np.asarray(getattr(jb, name))
        assert got.device.type == "cpu" and tuple(got.shape) == ref.shape, name
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    assert b.coords0.dtype == torch.int32 and b.n0.dtype == torch.int32


def test_collate_refuses_overflow_and_out_of_extent():
    from imfnet_tpu_torch.data.collate import collate_pairs
    from imfnet_tpu_torch.data.synthetic import synthetic_pair
    pair = synthetic_pair(np.random.RandomState(1), n_points=500, image_hw=(8, 8))
    with pytest.raises(ValueError, match="capacity"):
        collate_pairs([pair], 64, device="cpu")
    with pytest.raises(RuntimeError, match="grid_extent"):
        collate_pairs([pair], 2048, grid_extent=(4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        jcollate.collate_pairs([jcollate.VoxelizedPair(**vars(pair))], 64)   # as the JAX package


# ---- the positive search -----------------------------------------------------

def _brute_force(batch, radius):
    """f64 nearest same-pair voxel of side 1 for every valid voxel of side 0."""
    n0, n1 = int(batch.n0), int(batch.n1)
    c0, c1 = batch.coords0.numpy(), batch.coords1.numpy()
    x0, x1 = batch.xyz0.numpy().astype(np.float64), batch.xyz1.numpy().astype(np.float64)
    T = batch.T_gt.numpy().astype(np.float64)
    idx = np.zeros(n0, np.int64)
    d2 = np.zeros(n0)
    for b in range(T.shape[0]):
        rows = np.where(c0[:n0, 0] == b)[0]
        refs = np.where(c1[:n1, 0] == b)[0]
        moved = x0[rows] @ T[b, :3, :3].T + T[b, :3, 3]
        d = ((moved[:, None, :] - x1[refs][None]) ** 2).sum(-1)
        idx[rows] = refs[d.argmin(1)]
        d2[rows] = d.min(1)
    return idx, d2, d2 <= radius * radius


def test_positive_search_is_exact_for_both_pairs_and_the_reference_is_not(setup):
    """The port's search equals an f64 brute force on both pairs of the
    batch. The JAX package separates the pairs by adding pair * 1e5 to the
    coordinates in f32, which leaves pair 1's distances no resolution: its
    rows are all reported "ok", none of its matches is within the radius,
    and (almost) none is the true nearest voxel. Measured here, and the
    reason the port deviates."""
    batch = setup["batch"]._replace(pairs=None, pair_valid=None)
    n0 = int(batch.n0)
    idx, d2, ok = _brute_force(batch, RADIUS)
    pairs, got_ok = compute_correspondences(batch, RADIUS)
    pair_of = batch.coords0[:n0, 0].numpy()
    assert pairs.dtype == torch.int32 and (pairs[:, 0] == torch.arange(N_PAD)).all()
    margin = np.abs(d2 - RADIUS ** 2) > 1e-6        # f32 against f64 at the rim
    for b in (0, 1):
        rows = pair_of == b
        assert rows.sum() > 400
        np.testing.assert_array_equal(pairs[:n0, 1].numpy()[rows], idx[rows])
        np.testing.assert_array_equal(got_ok[:n0].numpy()[rows & margin], ok[rows & margin])
        assert ok[rows].mean() > 0.5                 # most voxels have a positive
    assert not got_ok[n0:].any()
    # a radius per pair: pair 1 searched with a tenth of the radius
    _, ok_r = compute_correspondences(batch, torch.tensor([RADIUS, RADIUS / 10]))
    rim = np.abs(d2 - (RADIUS / 10) ** 2) > 1e-7
    rows = pair_of == 1
    np.testing.assert_array_equal(ok_r[:n0].numpy()[rows & rim],
                                  (d2 <= (RADIUS / 10) ** 2)[rows & rim])

    jb = setup["jbatch"]._replace(pairs=None, pair_valid=None)
    jpairs, jok = jstep.compute_correspondences(jb, RADIUS)
    jidx, jok = np.asarray(jpairs)[:n0, 1], np.asarray(jok)[:n0]
    first, second = pair_of == 0, pair_of == 1
    np.testing.assert_array_equal(jidx[first], idx[first])      # pair 0: exact
    np.testing.assert_array_equal(jok[first & margin], ok[first & margin])
    # pair 1: the distance of each reported match, recomputed in f64
    x0, x1 = batch.xyz0.numpy().astype(np.float64), batch.xyz1.numpy().astype(np.float64)
    T1 = batch.T_gt.numpy().astype(np.float64)[1]
    moved = x0[:n0][second] @ T1[:3, :3].T + T1[:3, 3]
    true_d = np.sqrt(((moved - x1[jidx[second]]) ** 2).sum(1))
    assert jok[second].all()                        # every row of pair 1 "matched"
    assert (true_d > RADIUS).mean() > 0.95          # yet its matches are not within the radius
    assert (jidx[second] == idx[second]).mean() < 0.05


# ---- batch-norm statistics ---------------------------------------------------

def test_masked_batchnorm_running_statistics_match_flax():
    rng = np.random.RandomState(2)
    feats = [rng.randn(300, 24).astype(np.float32) * 2 + 1 for _ in range(2)]
    valids = [260, 1]      # the second side: one valid row (n clamps to 2)
    jbn = JaxMaskedBatchNorm(24, momentum=0.05)
    mask0 = np.arange(300) < valids[0]
    variables = _np(dict(jbn.init(jax.random.PRNGKey(0), jnp.asarray(feats[0]),
                                  jnp.asarray(mask0), jnp.asarray(valids[0]), train=False)))
    variables["params"] = {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
                           "bias": rng.randn(24).astype(np.float32)}
    bn = MaskedBatchNorm(24, momentum=0.05).train()
    bn.weight.data = _tensor(variables["params"]["scale"])
    bn.bias.data = _tensor(variables["params"]["bias"])
    stats = variables["batch_stats"]
    for f, n in zip(feats, valids):       # side 0, then side 1 on side 0's statistics
        mask = np.arange(300) < n
        ref, upd = jbn.apply({"params": variables["params"], "batch_stats": stats},
                             jnp.asarray(f), jnp.asarray(mask), jnp.asarray(n, jnp.int32),
                             train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        out = bn(_tensor(f), _tensor(mask), torch.tensor(n, dtype=torch.int32))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=2e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-6, atol=1e-7)
    # eval mode normalizes with what training left
    ref = jbn.apply({"params": variables["params"], "batch_stats": stats},
                    jnp.asarray(feats[0]), jnp.asarray(mask0), jnp.asarray(valids[0]), train=False)
    out = bn.eval()(_tensor(feats[0]), _tensor(mask0))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_trunk_running_statistics_match_flax():
    """flax ``BatchNorm`` stores the biased batch variance; so does the port."""
    rng = np.random.RandomState(3)
    images = [rng.rand(2, 24, 32, 3).astype(np.float32) for _ in range(2)]
    jtrunk = JaxTrunk(stage_sizes=(1, 1), compute_dtype=jnp.float32)
    variables = _np(dict(jax.jit(lambda x: jtrunk.init(jax.random.PRNGKey(1), x, train=False))(
        jnp.asarray(images[0]))))
    trunk = ResNetTrunk(stage_sizes=(1, 1), compute_dtype=torch.float32)
    sd = state_dict_from_flax({"params": {"img_encoder": variables["params"]},
                               "batch_stats": {"img_encoder": variables["batch_stats"]}})
    trunk.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    trunk.train()
    stats = variables["batch_stats"]
    for img in images:
        ref, upd = jtrunk.apply({"params": variables["params"], "batch_stats": stats},
                                jnp.asarray(img), train=True, mutable=["batch_stats"])
        stats = _np(upd["batch_stats"])
        out = trunk(_tensor(img))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        got = trunk.state_dict()
        for name, ref_stat in state_dict_from_flax(
                {"batch_stats": {"img_encoder": stats}}).items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[name.split(".", 1)[1]].numpy(), ref_stat.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


# ---- optimizers and schedule -------------------------------------------------

@pytest.mark.parametrize("name", ["SGD", "Adam"])
def test_optimizer_and_staircase_schedule_match_optax(name):
    rng = np.random.RandomState(4)
    p0 = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(5)]
    kw = dict(optimizer=name, lr=0.05, momentum=0.8, weight_decay=1e-2, exp_gamma=0.5)
    tx = jstate.make_optimizer(jax_config(**kw), steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    params = {k: torch.nn.Parameter(_tensor(v)) for k, v in p0.items()}
    opt, sched = make_optimizer(list(params.values()), threedmatch_config(**kw), steps_per_epoch=2)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        assert opt.param_groups[0]["lr"] == pytest.approx(0.05 * 0.5 ** (step // 2))
        for k, p in params.items():
            p.grad = _tensor(g[k])
        opt.step()
        sched.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} step {step}")


# ---- validation --------------------------------------------------------------

def test_irls_matches_jax():
    rng = np.random.RandomState(6)
    p0 = rng.randn(200, 3).astype(np.float32)
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    p1 = (p0 @ R.T + [0.1, -0.2, 0.05]).astype(np.float32)
    p1[:40] += rng.randn(40, 3).astype(np.float32)           # outliers
    valid = np.arange(200) < 180
    with jax.disable_jit():
        ref = np.asarray(jax_irls(jnp.asarray(p0), jnp.asarray(p1), valid=jnp.asarray(valid)))
    got = est_rigid_irls(_tensor(p0), _tensor(p1), valid=_tensor(valid)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:3, :3], R, atol=2e-2)     # and it finds the pose


def _val_pair():
    """A pair whose two sides hold the same voxels and image, so that their
    descriptors are equal row by row and the matches do not hang on
    near-ties between the two frameworks, while side 1's points are side 0's
    under a known pose: the geometry the metrics see is not trivial."""
    from imfnet_tpu_torch.data.synthetic import synthetic_pair
    p = synthetic_pair(np.random.RandomState(7), n_points=900, extent=0.45, image_hw=(24, 32))
    ang = 0.25
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    T[:3, 3] = [0.2, -0.1, 0.05]
    p.coords1, p.feats1, p.image1, p.T_gt = p.coords0, p.feats0, p.image0, T
    p.xyz1 = (p.xyz0 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return p


def test_val_step_metrics_match_jax(setup):
    """One pair through the eval-mode step with the same subsample draws."""
    from imfnet_tpu_torch.data.collate import collate_pairs
    jcfg = setup["jcfg"].replace(batch_size=1, val_subsample_size=512)
    cfg = setup["cfg"].replace(batch_size=1, val_subsample_size=512)
    pair = _val_pair()
    jb = jcollate.collate_pairs([jcollate.VoxelizedPair(**vars(pair))], N_PAD)
    b = collate_pairs([pair], N_PAD, device="cpu")
    key = jax.random.PRNGKey(9)
    v = setup["variables"]
    with jax.disable_jit():
        ref = jax_make_val_step(setup["jmodel"], jcfg)(v["params"], v["batch_stats"], jb, key)
    got = make_val_step(_port_model(cfg, v), cfg)(b, draws=_draws(key, (N_PAD, N_PAD)))
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].dim() == 0
        # rre is acos of an f32 cosine within a few ulp of 1: at 0.13 degrees
        # one ulp of the cosine moves it by 0.006 degrees
        tol = 2e-2 if k == "rre" else 1e-3 * max(1.0, abs(float(r)))
        np.testing.assert_allclose(float(got[k]), float(r), rtol=0, atol=tol, err_msg=k)
    assert float(got["hit_ratio"]) > 0.3 and float(got["rte"]) < 0.1


# ---- weights -----------------------------------------------------------------

def test_flax_from_state_dict_inverts_state_dict_from_flax(setup):
    v = setup["variables"]
    back = flax_from_state_dict(state_dict_from_flax(v))
    ref_leaves = jax.tree_util.tree_leaves_with_path({"params": v["params"],
                                                      "batch_stats": v["batch_stats"]})
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(ref_leaves) == len(got_leaves)
    for path, ref in ref_leaves:
        np.testing.assert_array_equal(got_leaves[path], ref, err_msg=str(path))
