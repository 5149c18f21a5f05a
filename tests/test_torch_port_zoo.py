"""Port parity, the SimpleNet zoo: the registry's 31 names, f32 forwards of
SimpleNet (BN and IN), SimpleNet2 and SimpleNet3 (5 levels) against the JAX
package's flax modules with the weights carried by ``state_dict_from_flax``,
the weights carried back, the config path (``build_model_from_config``,
``make_pyramid_fn`` at five levels), and one SimpleNet training step: loss
and every gradient against the JAX loss under ``jax.value_and_grad``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from imfnet_tpu.models import MODELS as JAX_MODELS
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.build import from_numpy
from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train import state as jstate
from imfnet_tpu.train import step as jstep

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.models import MODELS, load_model
from imfnet_tpu_torch.models.simpleunet import SimpleNet3
from imfnet_tpu_torch.sparse.coords import SparseVoxels
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.step import (compute_correspondences, level_capacities,
                                         make_pyramid_fn, make_train_step)
from imfnet_tpu_torch.train.trainer import build_model_from_config
from imfnet_tpu_torch.utils.flax_weights import flax_from_state_dict, state_dict_from_flax

from test_torch_port_model import _cloud, _randomize

CAPS5 = (512, 256, 128, 64, 64)
F32_ATOL = 1e-4   # f32 end to end; only the order of the f32 sums differs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers a thread pool per process oversubscribes the cores,
    and its barriers then cost far more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_has_the_jax_names():
    assert len(MODELS) == 31
    assert sorted(MODELS) == sorted(JAX_MODELS)
    assert sum(n.startswith("SimpleNet") for n in MODELS) == 21
    with pytest.raises(ValueError, match="not defined"):
        load_model("SimpleNetBN9")


@pytest.fixture(scope="module")
def inputs():
    """Two batches of a 5-level pyramid on both sides (both builders give
    the same tables at 5 levels; ``test_torch_port_sparse.py`` holds them
    at 4)."""
    rng = np.random.RandomState(3)
    coords = np.concatenate([_cloud(rng, 160, 0, span=16), _cloud(rng, 110, 1, span=16)])
    feats = rng.rand(len(coords), 1).astype(np.float32) + 0.5
    sv_j = from_numpy(coords, feats, CAPS5[0])
    pyr_j = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, num_levels=5, conv1_kernel_size=3, level_capacity=CAPS5))(
            sv_j.coords, sv_j.num_valid)
    sv_t = SparseVoxels(torch.tensor(np.asarray(sv_j.coords)),
                        torch.tensor(np.asarray(sv_j.feats)),
                        torch.tensor(int(sv_j.num_valid), dtype=torch.int32))
    pyr_t = build_pyramid(sv_t.coords, sv_t.num_valid, num_levels=5, conv1_kernel_size=3,
                          level_capacity=CAPS5)
    for lj, lt in zip(pyr_j.levels, pyr_t.levels):
        np.testing.assert_array_equal(np.asarray(lj.k3_same), lt.k3_same.numpy())
    return dict(sv_j=sv_j, pyr_j=pyr_j, sv_t=sv_t, pyr_t=pyr_t, rng=rng)


@pytest.mark.parametrize("name", ["SimpleNetBN", "SimpleNetIN", "SimpleNetBN2C",
                                  "SimpleNetIN2E", "SimpleNetBN3E", "SimpleNetIN3"])
def test_forward_equals_jax(inputs, name):
    """``eval()`` against ``train=False``, norms with randomized statistics."""
    kw = dict(in_channels=1, out_channels=16, conv1_kernel_size=3)
    jmodel = jax_load_model(name)(compute_dtype=jnp.float32, **kw)
    variables = jax.jit(lambda s, p: jmodel.init(jax.random.PRNGKey(0), s, p, None,
                                                 train=False))(inputs["sv_j"], inputs["pyr_j"])
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                           np.random.RandomState(4))
    want = np.asarray(jax.jit(lambda v, s, p: jmodel.apply(v, s, p, None, train=False))(
        variables, inputs["sv_j"], inputs["pyr_j"]))

    model = load_model(name)(compute_dtype=torch.float32, **kw)
    sd = state_dict_from_flax(variables)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.eval()(inputs["sv_t"], inputs["pyr_t"], None).numpy()
    assert got.shape == want.shape == (CAPS5[0], 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    n = int(inputs["sv_t"].num_valid)
    assert np.abs(got[n:]).max() == 0
    np.testing.assert_allclose(np.linalg.norm(got[:n], axis=1), 1.0, atol=1e-5)

    # and back: the port's state_dict gives the flax tree it came from
    back = flax_from_state_dict(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat)) == set(map(jax.tree_util.keystr, flat_back))
    by_path = {jax.tree_util.keystr(p): v for p, v in flat_back.items()}
    for p, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), by_path[jax.tree_util.keystr(p)])


def test_simplenet3_structure_and_a_shallow_pyramid(inputs):
    model = SimpleNet3(out_channels=8, conv1_kernel_size=3, compute_dtype=torch.float32)
    names = {n.split(".")[0] for n in model.state_dict()}
    assert "final" not in names and "norm1_tr" not in names
    assert {"conv5", "conv5_tr", "conv2_tr", "conv1_tr"} <= names
    assert model.conv1_tr.weight.shape == (27, 32 + 32, 8)
    shallow = inputs["pyr_t"]._replace(levels=inputs["pyr_t"].levels[:4])
    with pytest.raises(ValueError, match="5 levels"):
        model(inputs["sv_t"], shallow)


@pytest.mark.parametrize("map_impl", ["search", "banded"])
def test_config_path_builds_five_levels_for_simplenet3(map_impl):
    """``make_pyramid_fn`` gives one level per divisor, on both builders
    (kernel D's grouped entry takes the 13 maps of five levels), and
    ``build_model_from_config`` builds the SimpleNets without the
    occupancy conv1, which stays ResUNet-only."""
    cfg = threedmatch_config(model="SimpleNetBN3E", conv1_kernel_size=3, model_n_out=8,
                             compute_dtype="float32", level_capacity_divisors=(1, 2, 4, 8, 8),
                             grid_extent=(64, 64, 64))
    rng = np.random.RandomState(5)
    coords = _cloud(rng, 300, 0, span=24)
    coords[:, 1:] += 24
    order = np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1], coords[:, 0]))
    sv = from_numpy(coords[order], np.ones((len(coords), 1), np.float32), 512)
    c = torch.tensor(np.asarray(sv.coords))
    n = torch.tensor(int(sv.num_valid), dtype=torch.int32)
    pyr = make_pyramid_fn(cfg, 512, 1, map_impl=map_impl)(c, n)
    ref = build_pyramid(c, n, num_levels=5, conv1_kernel_size=3,
                        level_capacity=level_capacities(512, (1, 2, 4, 8, 8)))
    assert len(pyr.levels) == 5
    for a, b in zip(pyr.levels, ref.levels):
        for f in ("k3_same", "down", "up"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y), f
    for eval_fast in (False, True):
        model = build_model_from_config(cfg, eval_fast=eval_fast)
        assert type(model).__name__ == "SimpleNet3" and not hasattr(model, "conv1_occupancy")
        with torch.no_grad():
            out = model.eval()(SparseVoxels(c, torch.ones(512, 1), n), pyr)
        assert torch.isfinite(out).all() and out.shape == (512, 8)
    assert build_model_from_config(cfg.replace(model="ResUNetBN2C"),
                                   eval_fast=True).conv1_occupancy


# ---- one training step -------------------------------------------------------

SMALL = dict(batch_size=2, conv1_kernel_size=3, model_n_out=16, num_pos_per_batch=128,
             num_hn_samples_per_batch=64, max_points=1024, compute_dtype="float32",
             model="SimpleNetBN")
N_PAD = SMALL["max_points"]


def test_training_step_equals_jax():
    """The hardest-contrastive step of a SimpleNetBN on a two-pair batch with
    the same positives and draws: loss 1e-5, every gradient within 1e-3 of
    its tensor's largest entry (as for ResUNet in test_torch_port_train.py),
    the running statistics of both sides' batch norms 1e-5."""
    jcfg = jax_config(use_grid_maps=False, **SMALL)
    cfg = threedmatch_config(use_grid_maps=False, **SMALL)
    jbatch = jax_synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=400,
                                 n_pad=N_PAD, image_hw=(24, 32))
    batch = synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=400,
                            n_pad=N_PAD, image_hw=(24, 32), device="cpu")
    pairs, ok = compute_correspondences(batch, 0.0375)
    batch = batch._replace(pairs=pairs, pair_valid=ok)
    jbatch = jbatch._replace(pairs=jnp.asarray(pairs.numpy()), pair_valid=jnp.asarray(ok.numpy()))
    jmodel = jax_load_model("SimpleNetBN")(in_channels=1, out_channels=16, conv1_kernel_size=3,
                                           compute_dtype=jnp.float32)
    pyr0 = jax_build_pyramid(jbatch.coords0, jbatch.n0, conv1_kernel_size=3,
                             level_capacity=jstep.level_capacities(N_PAD))
    variables = jax.jit(lambda s, p: jmodel.init(jax.random.PRNGKey(0), s, p, None,
                                                 train=False))(
        JaxSparseVoxels(jbatch.coords0, jbatch.feats0, jbatch.n0), pyr0)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    key = jax.random.PRNGKey(7)
    st = jstate.create_train_state(variables, jstate.make_optimizer(jcfg, steps_per_epoch=10))
    loss_fn = jax.jit(jstep.make_loss_fn(jmodel, jcfg))
    (_, (jmetrics, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        st.params, st.batch_stats, jbatch, key)

    model = load_model("SimpleNetBN")(in_channels=1, out_channels=16, conv1_kernel_size=3,
                                      compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    state = create_train_state(model, cfg, steps_per_epoch=10)
    keys = jax.random.split(key, 3)
    draws = [torch.tensor(np.asarray(jax.random.uniform(k, (N_PAD,)))) for k in keys]
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    state, metrics = make_train_step(cfg)(state, batch, draws=draws)
    for h in hooks:
        h.remove()

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=0, atol=1e-5)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    ref = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    assert set(ref) == set(grads)
    for name, g in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-3 * max(np.abs(r).max(), 1e-6),
                                   err_msg=name)
    stats = state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, jstats)})
    got = state.model.state_dict()
    for name, r in stats.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=0, atol=1e-5, err_msg=name)
