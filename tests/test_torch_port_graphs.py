"""Port parity, the compiled programs: the training step, the validation
step and the pair's registration as the JAX package jits them, which the
port replays as CUDA graphs (``utils.graphs.jit``).

On the CPU each graphed entry point runs its graph's structure eagerly: the
random draws made outside in the eager order, then the body with the draws
given; for the training step also the capture-safe optimizer (a tensor
learning rate filled by the schedule, the fused update) and the schedule
stepped outside. That structure is held bit for bit to the port's plain
functions (``make_train_step``, ``make_val_step``, the stage-by-stage
registration) and, with the JAX package's draws injected, to the JAX
functions at the tolerances the existing parity tests state. The JAX side
runs un-jitted (``jax.disable_jit``). The replays on the card are in
``tests/test_torch_port_graphs_card.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data import collate as jcollate
from imfnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from imfnet_tpu.eval import registration as jreg
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train import step as jstep
from imfnet_tpu.train.validate import make_val_step as jax_make_val_step

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.collate import collate_pairs
from imfnet_tpu_torch.data.datasets import make_data_loader
from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.eval.registration import (make_keypoint_registration,
                                                make_pair_registration, sample_keypoints)
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.pipeline import PairRegistrar
from imfnet_tpu_torch.train.state import create_train_state, make_optimizer
from imfnet_tpu_torch.train.step import (LOSS_FNS, compute_correspondences,
                                         make_graphed_train_step, make_train_step)
from imfnet_tpu_torch.train.trainer import Trainer
from imfnet_tpu_torch.train.validate import make_graphed_val_step, make_val_step
from imfnet_tpu_torch.utils import graphs
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

from test_torch_port_graphs_card import (N_PAD, REG, SMALL, _assert_states_equal, _batch,  # noqa: F401
                                         _model, _reg_case, _registrar_config, _run_both,
                                         _val_pair)

RADIUS = 0.0375
TRIPLET = dict(triplet_num_pos=64, triplet_num_hn=64, triplet_num_rand=128)


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


def _draws(key, sizes):
    keys = jax.random.split(key, len(sizes))
    return [_tensor(jax.random.uniform(k, (n,))) for k, n in zip(keys, sizes)]


# ---- the training step -------------------------------------------------------

@pytest.mark.parametrize("trainer,optimizer", [(t, "SGD") for t in sorted(LOSS_FNS)]
                         + [("HardestContrastiveLossTrainer", "Adam")])
def test_graph_structured_step_equals_the_plain_step_bit_for_bit(trainer, optimizer):
    """Three steps crossing an epoch boundary of the schedule (two steps an
    epoch), the positives searched on the device: parameters, momentum,
    running statistics, metrics, the learning rate and the generator."""
    cfg = threedmatch_config(**SMALL, **TRIPLET, trainer=trainer, optimizer=optimizer,
                             exp_gamma=0.5)
    batch = _batch()
    states = [create_train_state(_model(cfg), cfg, steps_per_epoch=2) for _ in range(2)]
    for st in states:   # the card's optimizer, on the CPU
        st.optimizer, st.scheduler = make_optimizer(st.model.parameters(), cfg, 2,
                                                    capturable=True)
    mp, mg, gp, gg, _ = _run_both(cfg, batch, 3, "cpu", *states)
    _assert_states_equal(*states)
    assert float(states[0].optimizer.param_groups[0]["lr"]) == pytest.approx(cfg.lr * 0.5)
    assert isinstance(states[1].optimizer.param_groups[0]["lr"], torch.Tensor)
    for a, b in zip(mp, mg):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(gp.get_state(), gg.get_state())


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_the_capture_safe_optimizer_gives_the_eager_one_s_parameters(optimizer):
    """make_optimizer(capturable=True), the card's (a tensor rate the
    schedule fills, the fused update), against the CPU's eager optimizer
    over five steps and two epoch boundaries. The fused update may contract
    its multiply-adds otherwise than the eager one on another CPU: 1e-6."""
    cfg = threedmatch_config(optimizer=optimizer, lr=0.05, exp_gamma=0.5)
    rng = np.random.RandomState(0)
    init = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((40,), (8, 5))]
    runs = []
    for capturable in (False, True):
        ps = [p.clone().requires_grad_() for p in init]
        opt, sched = make_optimizer(ps, cfg, 2, capturable=capturable)
        grads = np.random.RandomState(1)
        for _ in range(5):
            for p in ps:
                p.grad = torch.from_numpy(grads.randn(*p.shape).astype(np.float32))
            opt.step()
            sched.step()
        runs.append((ps, float(opt.param_groups[0]["lr"])))
    (pe, lre), (pc, lrc) = runs
    assert lrc == pytest.approx(lre, rel=1e-7) and lre == pytest.approx(0.05 * 0.25)
    for a, b in zip(pe, pc):
        torch.testing.assert_close(b.detach(), a.detach(), rtol=1e-6, atol=1e-8)


def test_a_saved_optimizer_state_keeps_the_live_rate_tensor(tmp_path):
    """A state saved by the eager optimizer loads into the capture-safe
    one without replacing its rate tensor (a graph holds its address) or
    its update."""
    from imfnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    cfg = threedmatch_config(**SMALL)
    eager = create_train_state(_model(cfg), cfg, steps_per_epoch=2)
    make_train_step(cfg)(eager, _batch(), torch.Generator().manual_seed(0))
    eager.scheduler.step()     # two steps: the next epoch's rate
    path = save_checkpoint(str(tmp_path), "checkpoint", eager, cfg, 1, 0.0, 1,
                           cfg.best_val_metric, val_value=0.0)
    live = create_train_state(_model(cfg, seed=9), cfg, steps_per_epoch=2)
    live.optimizer, live.scheduler = make_optimizer(live.model.parameters(), cfg, 2,
                                                    capturable=True)
    rate = live.optimizer.param_groups[0]["lr"]
    load_checkpoint(path, live)
    group = live.optimizer.param_groups[0]
    assert group["lr"] is rate and group["fused"] is True
    assert float(rate) == pytest.approx(eager.optimizer.param_groups[0]["lr"])
    for a, b in zip(eager.optimizer.state_dict()["state"].values(),
                    live.optimizer.state_dict()["state"].values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])


@pytest.fixture(scope="module")
def jax_setup():
    """A two-pair batch with the port's positives, flax variables for the
    small model, and the JAX loss on it with its own draws."""
    jcfg = jax_config(use_grid_maps=False, **SMALL)
    cfg = threedmatch_config(**SMALL)
    jbatch = jax_synthetic_batch(np.random.RandomState(0), batch_size=2, n_points=700,
                                 n_pad=N_PAD, image_hw=(24, 32))
    batch = _batch()
    pairs, ok = compute_correspondences(batch, RADIUS)
    batch = batch._replace(pairs=pairs, pair_valid=ok)
    jbatch = jbatch._replace(pairs=jnp.asarray(pairs.numpy()), pair_valid=jnp.asarray(ok.numpy()))
    model = jax_load_model(jcfg.model)(
        in_channels=1, out_channels=jcfg.model_n_out, conv1_kernel_size=jcfg.conv1_kernel_size,
        normalize_feature=jcfg.normalize_feature, bn_momentum=jcfg.bn_momentum,
        compute_dtype=jnp.float32)
    pyr0 = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, conv1_kernel_size=3, level_capacity=jstep.level_capacities(N_PAD)))(
            jbatch.coords0, jbatch.n0)
    variables = jax.jit(lambda s, p, i: model.init(jax.random.PRNGKey(0), s, p, i, train=False))(
        JaxSparseVoxels(jbatch.coords0, jbatch.feats0, jbatch.n0), pyr0, jbatch.image0)
    variables = _np(dict(variables))
    return dict(jcfg=jcfg, cfg=cfg, jbatch=jbatch, batch=batch, jmodel=model,
                variables=variables)


def _port_model(cfg, variables):
    m = load_model(cfg.model)(in_channels=1, out_channels=cfg.model_n_out,
                              conv1_kernel_size=cfg.conv1_kernel_size,
                              compute_dtype=torch.float32, bn_momentum=cfg.bn_momentum)
    m.load_state_dict(state_dict_from_flax(variables), strict=True)
    return m


def test_graph_structured_step_metrics_match_jax(jax_setup):
    """The JAX loss with its key's draws against the graph-structured step
    given the same draws: loss 1e-5, as tests/test_torch_port_train.py."""
    s = jax_setup
    key = jax.random.PRNGKey(7)
    loss_fn = jstep.make_loss_fn(s["jmodel"], s["jcfg"])
    with jax.disable_jit():
        _, (jmetrics, _) = loss_fn(s["variables"]["params"], s["variables"]["batch_stats"],
                                   s["jbatch"], key)
    state = create_train_state(_port_model(s["cfg"], s["variables"]), s["cfg"], 10)
    state.optimizer, state.scheduler = make_optimizer(state.model.parameters(), s["cfg"], 10,
                                                      capturable=True)
    _, metrics = make_graphed_train_step(s["cfg"])(state, s["batch"],
                                                   draws=_draws(key, (N_PAD,) * 3))
    for k in ("loss", "pos_loss", "neg_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


# ---- the validation step -----------------------------------------------------

def test_graph_structured_val_step_equals_the_plain_step_bit_for_bit():
    cfg = threedmatch_config(**SMALL).replace(batch_size=1, val_subsample_size=512)
    b = collate_pairs([_val_pair()], N_PAD, device="cpu")
    model = _model(cfg).eval()
    gp = torch.Generator().manual_seed(3)
    gg = torch.Generator().manual_seed(3)
    want = make_val_step(model, cfg)(b, gp)
    got = make_graphed_val_step(model, cfg)(b, gg)
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    assert torch.equal(gp.get_state(), gg.get_state())


def test_graph_structured_val_step_matches_jax(jax_setup):
    """tests/test_torch_port_train_parts.py's tolerances."""
    s = jax_setup
    jcfg = s["jcfg"].replace(batch_size=1, val_subsample_size=512)
    cfg = s["cfg"].replace(batch_size=1, val_subsample_size=512)
    pair = _val_pair()
    jb = jcollate.collate_pairs([jcollate.VoxelizedPair(**vars(pair))], N_PAD)
    b = collate_pairs([pair], N_PAD, device="cpu")
    key = jax.random.PRNGKey(9)
    v = s["variables"]
    with jax.disable_jit():
        ref = jax_make_val_step(s["jmodel"], jcfg)(v["params"], v["batch_stats"], jb, key)
    got = make_graphed_val_step(_port_model(cfg, v), cfg)(b, draws=_draws(key, (N_PAD, N_PAD)))
    assert set(got) == set(ref)
    for k, r in ref.items():
        tol = 2e-2 if k == "rre" else 1e-3 * max(1.0, abs(float(r)))
        np.testing.assert_allclose(float(got[k]), float(r), rtol=0, atol=tol, err_msg=k)


# ---- registration ------------------------------------------------------------

def test_graph_structured_register_equals_the_stagewise_one_bit_for_bit():
    """register's draws made before the rest equal the draws the stages
    make as they go (keys of side 0, side 1, then RANSAC's)."""
    xyz0, f0, n0, xyz1, f1, n1, T = (torch.as_tensor(a) for a in _reg_case())
    cov = torch.eye(6)
    gr = torch.Generator().manual_seed(8)
    gs = torch.Generator().manual_seed(8)
    got = make_pair_registration(**REG)(xyz0, f0, n0, xyz1, f1, n1, T, cov, generator=gr)
    register_kp = make_keypoint_registration(**{k: v for k, v in REG.items()
                                                if k != "num_keypoints"})
    v0 = torch.arange(xyz0.shape[0]) < n0
    v1 = torch.arange(xyz1.shape[0]) < n1
    i0, ok0 = sample_keypoints(v0, REG["num_keypoints"], generator=gs)
    i1, ok1 = sample_keypoints(v1, REG["num_keypoints"], generator=gs)
    want = register_kp(xyz0[i0], f0[i0], ok0, xyz1[i1], f1[i1], ok1, T, cov, generator=gs)
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    assert torch.equal(gr.get_state(), gs.get_state())
    assert bool(got["accepted"])


def test_graph_structured_register_matches_jax():
    """The JAX register's key split three ways: both sides' keys, and its
    RANSAC samples injected as indices. Transform 1e-4 (FIT_ATOL of
    tests/test_torch_port_match.py), the scalar metrics 1e-5."""
    xyz0, f0, n0, xyz1, f1, n1, T = _reg_case()
    key = jax.random.PRNGKey(21)
    with jax.disable_jit():
        ref = jreg.make_pair_registration(**REG)(key, xyz0, f0, n0, xyz1, f1, n1, T,
                                                 np.eye(6, dtype=np.float32))
    k0, k1, k2 = jax.random.split(key, 3)
    u = tuple(_tensor(jax.random.uniform(k, (800,))) for k in (k0, k1))
    n_blocks = REG["num_hypotheses"] // REG["hypo_block"]
    n_valid = min(n0, REG["num_keypoints"])
    samples = np.stack([np.asarray(jax.random.randint(
        k, (REG["hypo_block"], REG["ransac_n"]), 0, n_valid))
        for k in jax.random.split(k2, n_blocks)])
    got = make_pair_registration(**REG)(*(torch.as_tensor(a) for a in (xyz0, f0)), n0,
                                        *(torch.as_tensor(a) for a in (xyz1, f1)), n1,
                                        torch.as_tensor(T), torch.eye(6), keypoint_u=u,
                                        samples=torch.from_numpy(samples))
    np.testing.assert_allclose(got["transformation"].numpy(),
                               np.asarray(ref["transformation"]), rtol=0, atol=1e-4)
    for k in ("rr", "ir", "inlier_ratio_mutual", "num_inliers", "fitness"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=0, atol=1e-5, err_msg=k)


def test_pair_registrar_chain_equals_its_stages_bit_for_bit():
    """PairRegistrar's call (draws first, then pyramid → forward → match,
    the card's graph) against its stages called one by one, each drawing as
    it goes; on the CPU there is no graph."""
    cfg = _registrar_config()
    pair = synthetic_pair(np.random.RandomState(2), n_points=6000, image_hw=(24, 32))
    reg = PairRegistrar(cfg, device="cpu", seed=1)
    assert reg.graphed is None
    args = (pair.xyz0, pair.xyz1, pair.image0, pair.image1)
    gc = torch.Generator().manual_seed(4)
    gs = torch.Generator().manual_seed(4)
    got = reg(*args, pair.T_gt, np.eye(6), generator=gc)
    pb = reg.prepare(*args)
    q = reg.quantize(pb)
    feats = reg.forward(q, reg.pyramid(q), pb.images)
    want = reg.match(q, feats, pair.T_gt, np.eye(6), generator=gs)
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    assert torch.equal(gc.get_state(), gs.get_state())


# ---- the graph wrapper and the trainer on the CPU ------------------------------

def test_jit_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.jit(lambda x: x + 1)(torch.zeros(3))
    with pytest.raises(ValueError, match="no tensor"):
        graphs.jit(lambda x: x)(3)


def test_views_of_one_slab_are_copied_in_as_one_buffer():
    """The static layout of a staged batch: views of one buffer stay views
    of one static buffer; a later call laid out alike is one copy, any
    other layout is copied view by view."""
    slab = torch.arange(256, dtype=torch.uint8)
    views = [slab[0:16].view(torch.int32), slab[64:96].view(torch.float32).view(2, 4)]
    st = graphs._Slab([0, 1], views)
    assert graphs._Slab.fits(views)
    assert st.buf.numel() == 96 and st.rel == (0, 64)
    assert all(torch.equal(a, b) for a, b in zip(st.views, views))
    other = torch.arange(256, dtype=torch.uint8).flip(0).contiguous()
    st.copy_in([other[0:16].view(torch.int32), other[64:96].view(torch.float32).view(2, 4)])
    assert torch.equal(st.buf, other[:96])
    apart = [torch.full((4,), 7, dtype=torch.int32), torch.ones(2, 4)]
    st.copy_in(apart)
    assert all(torch.equal(a, b) for a, b in zip(st.views, apart))
    # a buffer mostly unused by its views is not taken as one
    assert not graphs._Slab.fits([slab[0:4], slab[200:204]])


def test_the_trainer_stays_eager_on_the_cpu(tmp_path):
    cfg = threedmatch_config(**SMALL).replace(
        dataset="SyntheticPairDataset", synthetic_length=2, synthetic_n_points=400,
        max_points=1024, voxel_size=0.05, batch_size=1, out_dir=str(tmp_path))
    t = Trainer(cfg, make_data_loader(cfg, "train", 1), None, device="cpu")
    assert t.graphed is False
    assert not hasattr(t.train_step, "graphed") and not hasattr(t.val_step, "graphed")
