"""Port parity, the training step: one whole step (loss, every gradient,
updated parameters and buffers) against the JAX package on the same numpy
inputs and random draws, gradient accumulation against the fused step, and
eight steps lowering the loss. The JAX side runs un-jitted
(``jax.disable_jit``) at a small size: compiling its training step on the CPU
takes minutes. The step's parts are held in ``test_torch_port_train_parts.py``."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train import state as jstate
from imfnet_tpu.train import step as jstep

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.step import (compute_correspondences, make_accum_steps,
                                         make_train_step)
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

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


# ---- the training step -------------------------------------------------------

@pytest.fixture(scope="module")
def stepped(setup):
    """One training step on both sides from the same variables and draws."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    key = jax.random.PRNGKey(7)
    tx = jstate.make_optimizer(jcfg, steps_per_epoch=10)
    jstate0 = jstate.create_train_state(setup["variables"], tx)
    loss_fn = jstep.make_loss_fn(setup["jmodel"], jcfg)
    # the body of jstep.make_train_step's train_step, keeping the gradients
    # (one un-jitted pass through the JAX model instead of two)
    with jax.disable_jit():
        (_, (jmetrics, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
            jstate0.params, jstate0.batch_stats, setup["jbatch"], key)
    updates, opt_state = tx.update(jgrads, jstate0.opt_state, jstate0.params)
    jstate1 = jstate.TrainState(step=jstate0.step + 1,
                                params=optax.apply_updates(jstate0.params, updates),
                                batch_stats=jstats, opt_state=opt_state)

    model = _port_model(cfg, setup["variables"])
    state = create_train_state(model, cfg, steps_per_epoch=10)
    draws = _draws(key, (N_PAD, N_PAD, N_PAD))
    grads = {}
    hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
             for n, p in model.named_parameters()]
    state, metrics = make_train_step(cfg)(state, setup["batch"], draws=draws)
    for h in hooks:
        h.remove()
    return dict(jmetrics=jmetrics, jgrads=_np(jgrads), jstate1=jstate1, state=state,
                metrics=metrics, grads=grads, draws=draws)


def test_train_step_loss_matches_jax(stepped):
    for k in ("loss", "pos_loss", "neg_loss"):
        assert stepped["metrics"][k].dim() == 0 and not stepped["metrics"][k].requires_grad
        np.testing.assert_allclose(float(stepped["metrics"][k]), float(stepped["jmetrics"][k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_train_step_gradients_match_jax(stepped):
    ref = state_dict_from_flax({"params": stepped["jgrads"]})
    assert set(ref) == set(stepped["grads"])
    for name, g in stepped["grads"].items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-3 * max(np.abs(r).max(), 1e-6),
                                   err_msg=name)


def test_train_step_updates_parameters_and_buffers_like_jax(stepped):
    j1 = stepped["jstate1"]
    ref = state_dict_from_flax({"params": _np(j1.params), "batch_stats": _np(j1.batch_stats)})
    got = stepped["state"].model.state_dict()
    assert stepped["state"].step == 1 == int(j1.step)
    for name, r in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        r = r.numpy()
        # lr 0.1 times a gradient held to 1e-3 of its largest entry
        np.testing.assert_allclose(got[name].numpy(), r, rtol=0,
                                   atol=2e-4 * max(np.abs(r).max(), 1e-3), err_msg=name)


def test_accumulation_over_two_micro_batches_equals_the_fused_step(setup, stepped):
    """Gradients are taken at fixed parameters and scaled by 1/iter_size, so
    two identical micro-batches give the fused step's update; only the
    running statistics move twice."""
    cfg = setup["cfg"].replace(iter_size=2)
    model = _port_model(cfg, setup["variables"])
    state = create_train_state(model, cfg, steps_per_epoch=10)
    grad_step, apply_step = make_accum_steps(cfg)
    for _ in range(2):
        metrics = grad_step(state, setup["batch"], draws=stepped["draws"])
    state = apply_step(state)
    assert state.step == 1 and all(p.grad is None for p in model.parameters())
    np.testing.assert_allclose(float(metrics["loss"]), float(stepped["metrics"]["loss"]),
                               rtol=0, atol=1e-6)
    fused = dict(stepped["state"].model.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), fused[name].detach().numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=name)
    moved = (model.norm1.bn.running_mean - stepped["state"].model.norm1.bn.running_mean).abs().max()
    assert float(moved) > 0


def test_eight_steps_lower_the_loss(setup):
    cfg = setup["cfg"].replace(lr=0.03)
    torch.manual_seed(0)
    model = load_model(cfg.model)(in_channels=1, out_channels=cfg.model_n_out,
                                  conv1_kernel_size=cfg.conv1_kernel_size,
                                  compute_dtype=torch.float32)
    state = create_train_state(model, cfg, steps_per_epoch=100)
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    batch = setup["batch"]._replace(pairs=None, pair_valid=None)   # the search on the device
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


