"""Port parity, the data-parallel step (``parallel/dp.py``, ``train/step.py``
with a mesh): the port's ``make_emulated_dp_step`` against the JAX
package's with two devices on the same numpy inputs and the JAX draws
(injected); two gloo ranks against the port's emulation, bit for bit, both
ranks ending with the same parameters; and the step of a one-rank mesh
against the step without one, bit for bit. The JAX side runs un-jitted
(``jax.disable_jit``), as in ``test_torch_port_train.py``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from imfnet_tpu.parallel.dp import make_emulated_dp_step as jax_emulated_dp_step
from imfnet_tpu.parallel.dp import stack_batches as jax_stack_batches
from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train import state as jstate
from imfnet_tpu.train import step as jstep

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.parallel import dp
from imfnet_tpu_torch.parallel.mesh import Mesh, close_mesh, make_mesh, spawn_ranks
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.step import compute_correspondences, make_train_step
from imfnet_tpu_torch.train.trainer import build_model_from_config
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

from test_torch_port_train import _draws, _jax_model, _np, _one_torch_thread, _port_model  # noqa: F401

# the config of test_torch_port_train.py, two pairs a device: with one the
# image trunk's batch norms see a dozen values a channel at 24 x 32, which
# turns f32 rounding into percent-sized gradient differences with JAX
SMALL = dict(batch_size=2, conv1_kernel_size=3, model_n_out=16, num_pos_per_batch=128,
             num_hn_samples_per_batch=64, max_points=2048, compute_dtype="float32")
N_PAD = SMALL["max_points"]
IMAGE_HW = (24, 32)
RADIUS = 0.0375


def _batches(seed, n, jax_too=False):
    """``n`` two-pair batches with the positives the port's search finds,
    and (``jax_too``) the same batches for the JAX package."""
    out, jout = [], []
    for i in range(n):
        b = synthetic_batch(np.random.RandomState(seed + i), batch_size=2, n_points=700,
                            n_pad=N_PAD, image_hw=IMAGE_HW, device="cpu")
        pairs, ok = compute_correspondences(b, RADIUS)
        out.append(b._replace(pairs=pairs, pair_valid=ok))
        if jax_too:
            jb = jax_synthetic_batch(np.random.RandomState(seed + i), batch_size=2,
                                     n_points=700, n_pad=N_PAD, image_hw=IMAGE_HW)
            jout.append(jb._replace(pairs=jnp.asarray(pairs.numpy()),
                                    pair_valid=jnp.asarray(ok.numpy())))
    return out, jout


def test_emulated_dp_step_matches_jax():
    """Two devices, one step: the mean loss, the mean gradients (read from
    the momentum buffers, g + wd·p after one step), the parameters and the
    averaged running statistics against JAX's ``make_emulated_dp_step``."""
    jcfg = jax_config(use_grid_maps=False, **SMALL)
    cfg = threedmatch_config(**SMALL)
    # test_torch_port_train.py's batch (seed 0) and the next
    batches, jbatches = _batches(0, 2, jax_too=True)
    jmodel = _jax_model(jcfg)
    jb0 = jbatches[0]
    pyr0 = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, conv1_kernel_size=3, level_capacity=jstep.level_capacities(N_PAD)))(
            jb0.coords0, jb0.n0)
    variables = _np(dict(jax.jit(lambda s, p, i: jmodel.init(
        jax.random.PRNGKey(0), s, p, i, train=False))(
            JaxSparseVoxels(jb0.coords0, jb0.feats0, jb0.n0), pyr0, jb0.image0)))
    tx = jstate.make_optimizer(jcfg, steps_per_epoch=10)
    j0 = jstate.create_train_state(variables, tx)
    key = jax.random.PRNGKey(3)
    with jax.disable_jit():
        j1, jmetrics = jax_emulated_dp_step(jmodel, tx, jcfg, 2)(
            j0, jax_stack_batches(jbatches), jnp.stack([key, key]))

    model = _port_model(cfg, variables)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = create_train_state(model, cfg, steps_per_epoch=10)
    draws = [_draws(jax.random.fold_in(key, d), (N_PAD, N_PAD, N_PAD)) for d in range(2)]
    state, metrics = dp.make_emulated_dp_step(cfg, 2)(state, batches, draws=draws)
    assert state.step == 1
    for k in ("loss", "pos_loss", "neg_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    arrays = dp.train_state_arrays(state)
    trace = state_dict_from_flax({"params": _np(j1.opt_state[1].trace)})
    assert set(trace) == set(arrays["momentum"])
    wd = cfg.weight_decay
    for name, mom in arrays["momentum"].items():
        g_ref = trace[name].numpy() - wd * p0[name].numpy()
        g = mom.numpy() - wd * p0[name].numpy()
        np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-3 * max(np.abs(g_ref).max(), 1e-6),
                                   err_msg=name)
    ref = state_dict_from_flax({"params": _np(j1.params), "batch_stats": _np(j1.batch_stats)})
    for name, r in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        r = r.numpy()
        np.testing.assert_allclose(arrays["model"][name].numpy(), r, rtol=0,
                                   atol=2e-4 * max(np.abs(r).max(), 1e-3), err_msg=name)
    # the running statistics moved
    before = state_dict_from_flax(variables)["norm1.bn.running_mean"]
    assert float((arrays["model"]["norm1.bn.running_mean"] - before).abs().max()) > 0


@pytest.fixture(scope="module")
def two_rank_run():
    """Two DP steps on two gloo ranks, each on its own batch (the search on
    the device finds the positives), from one seeded model."""
    cfg = threedmatch_config(**SMALL)
    batches, _ = _batches(20, 4)
    groups = [[b._replace(pairs=None, pair_valid=None) for b in batches[i:i + 2]]
              for i in (0, 2)]
    start = {k: v.clone() for k, v in build_model_from_config(cfg).state_dict().items()}
    ranks = spawn_ranks(dp.run_dp_steps, ["cpu", "cpu"], (cfg, start, groups, "search", 10))
    return cfg, start, groups, ranks


def _assert_equal_states(a, b, what):
    for part in ("model", "momentum"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), f"{what}: {part} {k}"


def test_two_gloo_ranks_equal_the_emulation_bit_for_bit(two_rank_run):
    cfg, start, groups, ranks = two_rank_run
    assert [len(r["ms"]) for r in ranks] == [2, 2]
    _assert_equal_states(ranks[0], ranks[1], "rank 0 vs rank 1")
    model = build_model_from_config(cfg)
    model.load_state_dict(start)
    state = create_train_state(model, cfg, steps_per_epoch=10)
    gens = [dp.rank_generator(cfg.seed, d, "cpu") for d in range(2)]
    step = dp.make_emulated_dp_step(cfg, 2, map_impl="search")
    for s, group in enumerate(groups):
        state, metrics = step(state, group, gens)
        for k, v in metrics.items():
            assert float(v) == ranks[0]["metrics"][s][k] == ranks[1]["metrics"][s][k], k
    _assert_equal_states(dp.train_state_arrays(state), ranks[0], "emulation vs ranks")
    # each rank drew its own stream: rank 1's seed is not rank 0's
    assert dp.rank_seed(cfg.seed, 0) == cfg.seed != dp.rank_seed(cfg.seed, 1)


def test_two_ranks_differ_from_one_batch_steps(two_rank_run):
    """The average is over both ranks' batches: a plain step on rank 0's
    batch alone ends elsewhere."""
    cfg, start, groups, ranks = two_rank_run
    model = build_model_from_config(cfg)
    model.load_state_dict(start)
    state = create_train_state(model, cfg, steps_per_epoch=10)
    gen = dp.rank_generator(cfg.seed, 0, "cpu")
    step = make_train_step(cfg, map_impl="search")
    for group in groups:
        state, _ = step(state, group[0], gen)
    got = dp.train_state_arrays(state)["model"]
    assert any(not torch.equal(got[k], ranks[0]["model"][k]) for k in got)


def test_one_rank_mesh_step_equals_the_plain_step():
    cfg = threedmatch_config(**SMALL)
    batches, _ = _batches(30, 2)
    start = build_model_from_config(cfg).state_dict()
    runs = []
    mesh = make_mesh(devices=["cpu"])
    try:
        assert mesh == Mesh(1, 0, torch.device("cpu"), mesh.group, "gloo")
        for m in (None, mesh):
            model = build_model_from_config(cfg)
            model.load_state_dict(start)
            state = create_train_state(model, cfg, steps_per_epoch=10)
            step = make_train_step(cfg, map_impl="search", mesh=m)
            gen = torch.Generator().manual_seed(0)
            metrics = []
            for b in batches:
                state, out = step(state, b, gen)
                metrics.append({k: float(v) for k, v in out.items()})
            runs.append((dp.train_state_arrays(state), metrics))
    finally:
        close_mesh()
    _assert_equal_states(runs[0][0], runs[1][0], "mesh vs none")
    assert runs[0][1] == runs[1][1]
