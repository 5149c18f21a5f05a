"""Three faults of the port against the JAX package, each held by a test:
an eval-mode forward is differentiable (against ``jax.grad``), the training
and validation steps build the pyramid ``config.use_grid_maps`` asks for
(the grid pyramid equal to the search pyramid, bit for bit on the CPU), and
``PairRegistrar`` refuses a pyramid whose coarse levels overflow."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.data.collate import collate_pairs as jax_collate_pairs
from imfnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train.step import level_capacities as jax_level_capacities

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.collate import collate_pairs
from imfnet_tpu_torch.data.datasets import PairDataset, _compose_jitter
from imfnet_tpu_torch.data.synthetic import synthetic_batch, synthetic_pair
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.pipeline import PairRegistrar, bench_config
from imfnet_tpu_torch.sparse.coords import SparseVoxels
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid, coarse_levels_fit
from imfnet_tpu_torch.train import step as pstep
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.validate import make_val_step
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

SMALL = dict(batch_size=2, conv1_kernel_size=3, model_n_out=16, num_pos_per_batch=128,
             num_hn_samples_per_batch=64, max_points=2048, compute_dtype="float32")
N_PAD = SMALL["max_points"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers a thread pool per process oversubscribes the cores,
    and its barriers then cost far more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(pyr):
    out = {"k5": pyr.k5_l0}
    for i, lv in enumerate(pyr.levels):
        out[f"n{i}"] = lv.num_valid
        for name in ("coords", "k3_same", "down", "up"):
            if getattr(lv, name) is not None:
                out[f"{name}{i}"] = getattr(lv, name)
    return out


# ---- 1: an eval-mode forward is differentiable --------------------------------

def test_eval_mode_gradient_to_the_image_matches_jax():
    """d descriptor[row, channel] / d image of a forward in ``eval()`` mode
    against ``jax.grad`` of the JAX model with ``train=False`` on the same
    weights: within 1e-4 of the gradient's largest entry (f32)."""
    jb = jax_synthetic_batch(np.random.RandomState(0), batch_size=1, n_points=500,
                             n_pad=N_PAD, image_hw=(24, 32))
    b = synthetic_batch(np.random.RandomState(0), batch_size=1, n_points=500,
                        n_pad=N_PAD, image_hw=(24, 32), device="cpu")
    jmodel = jax_load_model("ResUNetBN2C")(in_channels=1, out_channels=16,
                                           conv1_kernel_size=3, compute_dtype=jnp.float32)
    sv = JaxSparseVoxels(jb.coords0, jb.feats0, jb.n0)
    pyr = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, conv1_kernel_size=3, level_capacity=jax_level_capacities(N_PAD)))(
            jb.coords0, jb.n0)
    variables = jax.jit(lambda s, p, i: jmodel.init(jax.random.PRNGKey(0), s, p, i,
                                                    train=False))(sv, pyr, jb.image0)
    row, ch = int(jb.n0) // 2, 3
    with jax.disable_jit():   # compiling the backward on the CPU takes minutes
        want = np.asarray(jax.grad(
            lambda img: jmodel.apply(variables, sv, pyr, img, train=False)[row, ch])(jb.image0))

    model = load_model("ResUNetBN2C")(in_channels=1, out_channels=16, conv1_kernel_size=3,
                                      compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                      dict(variables))))
    model.eval()
    image = b.image0.clone().requires_grad_(True)
    tpyr = build_pyramid(b.coords0, b.n0, conv1_kernel_size=3,
                         level_capacity=pstep.level_capacities(N_PAD))
    out = model(SparseVoxels(b.coords0, b.feats0, b.n0), tpyr, image)
    assert out.requires_grad
    (got,) = torch.autograd.grad(out[row, ch], image)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    # running statistics did not move, and no_grad still gives a plain tensor
    assert float(model.norm1.bn.running_var.min()) == 1.0
    with torch.no_grad():
        assert not model(SparseVoxels(b.coords0, b.feats0, b.n0), tpyr, b.image0).requires_grad


def test_registrar_forward_records_no_graph():
    cfg = bench_config().replace(compute_dtype="float32", level_capacity_divisors=(1, 2, 4, 8))
    pair = synthetic_pair(np.random.RandomState(2), n_points=3000, image_hw=(24, 32))
    reg = PairRegistrar(cfg, device="cpu")
    pb = reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1)
    q = reg.quantize(pb)
    feats = reg.forward(q, reg.pyramid(q), pb.images)
    assert not feats.requires_grad and feats.grad_fn is None


# ---- 2: config.use_grid_maps reaches the steps --------------------------------

@pytest.fixture(scope="module")
def batch():
    return synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=700,
                           n_pad=N_PAD, image_hw=(24, 32), device="cpu")


def _one_step(cfg, batch, map_impl):
    torch.manual_seed(0)
    model = load_model(cfg.model)(in_channels=1, out_channels=cfg.model_n_out,
                                  conv1_kernel_size=cfg.conv1_kernel_size,
                                  compute_dtype=torch.float32)
    state = create_train_state(model, cfg, steps_per_epoch=10)
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    state, metrics = pstep.make_train_step(cfg, map_impl=map_impl)(
        state, batch, torch.Generator().manual_seed(3))
    for h in hooks:
        h.remove()
    return metrics, grads, model.state_dict()


def test_train_step_banded_equals_search_bit_for_bit(batch):
    cfg = threedmatch_config(**SMALL)
    ms, gs, sds = _one_step(cfg, batch, "search")
    mb, gb, sdb = _one_step(cfg, batch, "banded")
    assert ms.keys() == mb.keys() and gs.keys() == gb.keys() and len(gs) > 50
    for k in ms:
        assert torch.equal(ms[k], mb[k]), k
    for k in gs:
        assert torch.equal(gs[k], gb[k]), k
    for k in sds:   # updated parameters and running statistics
        assert torch.equal(sds[k], sdb[k]), k


@pytest.mark.parametrize("use_grid", [True, False])
def test_steps_follow_use_grid_maps(batch, use_grid, monkeypatch):
    """With no ``map_impl`` the training, accumulation and validation steps
    build the grid pyramid exactly when the config sets ``use_grid_maps``."""
    calls = {"grid": 0, "search": 0}
    grid, search = pstep.build_pyramid_grid, pstep.build_pyramid

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pstep, "build_pyramid_grid", count("grid", grid))
    monkeypatch.setattr(pstep, "build_pyramid", count("search", search))
    cfg = threedmatch_config(**dict(SMALL, use_grid_maps=use_grid, iter_size=2))
    assert pstep.default_map_impl(cfg) == ("banded" if use_grid else "search")
    torch.manual_seed(0)
    model = load_model(cfg.model)(in_channels=1, out_channels=16, conv1_kernel_size=3,
                                  compute_dtype=torch.float32)
    state = create_train_state(model, cfg, steps_per_epoch=10)
    gen = torch.Generator().manual_seed(0)
    pstep.make_train_step(cfg)(state, batch, gen)
    grad_step, apply_step = pstep.make_accum_steps(cfg)
    grad_step(state, batch, gen)
    apply_step(state)
    one = synthetic_batch(np.random.RandomState(1), batch_size=1, n_points=700,
                          n_pad=N_PAD, image_hw=(24, 32), device="cpu")
    out = make_val_step(model, cfg, subsample_size=256)(one, gen)
    assert np.isfinite(float(out["loss"]))
    want = {"grid": 6, "search": 0} if use_grid else {"grid": 0, "search": 6}
    assert calls == want
    with pytest.raises(ValueError, match="map_impl"):
        pstep.make_train_step(cfg, map_impl="dense")(state, batch, gen)


def test_a_sample_beyond_the_extent_is_refused_as_in_the_reference():
    pair = synthetic_pair(np.random.RandomState(0), n_points=700, image_hw=(24, 32))
    assert (pair.coords0.max(0) - pair.coords0.min(0) + 1).max() > 32
    with pytest.raises(RuntimeError, match="grid_extent"):
        collate_pairs([pair], N_PAD, grid_extent=(32, 32, 32), device="cpu")
    with pytest.raises(RuntimeError, match="grid_extent"):
        jax_collate_pairs([pair], N_PAD, grid_extent=(32, 32, 32))
    collate_pairs([pair], N_PAD, grid_extent=(256, 256, 256), device="cpu")


@pytest.mark.parametrize("scale,rotation,jitter", [(True, True, True), (False, True, False),
                                                   (True, False, True), (False, False, False)])
def test_augmented_batches_give_equal_banded_and_search_pyramids(scale, rotation, jitter):
    """Every augmentation setting gives a batch whose word tables are sorted
    (the banded maps assert it and have no dense fallback) and whose
    banded pyramid equals the search pyramid."""
    cfg = threedmatch_config(**dict(SMALL, voxel_size=0.05))
    ds = PairDataset("train", cfg, random_rotation=rotation, random_scale=scale,
                     transform=_compose_jitter() if jitter else None)
    ds.reset_seed(1)
    rng = np.random.RandomState(0)
    img = np.zeros((24, 32, 3), np.float32)
    samples = []
    for _ in range(2):
        xyz = rng.rand(900, 3) * 2.0 - 1.0
        a0, a1, trans, radius = ds._augment(xyz[:700], xyz[200:])
        samples.append(ds._finalize(a0, a1, trans, img, img, radius))
    b = collate_pairs(samples, N_PAD, grid_extent=tuple(cfg.grid_extent), device="cpu")
    for coords, n in ((b.coords0, b.n0), (b.coords1, b.n1)):
        banded = pstep.make_pyramid_fn(cfg, N_PAD, 2, map_impl="banded")(coords, n)
        search = pstep.make_pyramid_fn(cfg, N_PAD, 2, map_impl="search")(coords, n)
        tb, ts = _tables(banded), _tables(search)
        assert tb.keys() == ts.keys()
        for k in ts:
            assert torch.equal(tb[k], ts[k]), k


# ---- 3: PairRegistrar refuses a truncated pyramid -----------------------------

def test_registrar_raises_when_a_coarse_level_overflows():
    """A 6000-point cloud is sparse: its stride-2 level holds more than a
    third of its voxels, so the bench's divisors (1, 3, 8, 20) overflow."""
    pair = synthetic_pair(np.random.RandomState(2), n_points=6000, image_hw=(24, 32))
    reg = PairRegistrar(bench_config().replace(compute_dtype="float32"), device="cpu")
    q = reg.quantize(reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1))
    with pytest.raises(RuntimeError, match="overflows its capacity"):
        reg.pyramid(q)
    with pytest.raises(RuntimeError, match="overflows its capacity"):
        reg(pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6))
    fits = PairRegistrar(bench_config().replace(compute_dtype="float32",
                                                level_capacity_divisors=(1, 2, 4, 8)),
                         device="cpu")
    assert bool(coarse_levels_fit(fits.pyramid(q)))


@pytest.mark.parametrize("map_impl", ["search", "banded"])
def test_registrar_takes_the_bench_scale_pair(map_impl):
    pair = synthetic_pair(np.random.RandomState(0), n_points=200_000)
    reg = PairRegistrar(device="cpu", map_impl=map_impl)
    q = reg.quantize(reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1))
    pyr = reg.pyramid(q)
    assert q.sv.n_padded == 65536 and bool(coarse_levels_fit(pyr))
    assert 58000 < int(pyr.levels[0].num_valid) < 60000
