"""Port parity, the trainer around the step. The loop's structure (scalar
tags and counts, step numbers, checkpoint names and their ``meta.json``,
best-validation gating and its tie rule, the starved-epoch error) is held
equal to the JAX ``Trainer`` with the steps of both replaced by the same
scripted results, which needs no compile of the JAX step; the first training
loss is held to the JAX loss function on the same batch and weights (1e-5).
Accumulation, resume, the four loss kinds and the device rules are the
port's own and run real steps at a small size."""
import collections
import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data.datasets import make_data_loader as jax_make_data_loader
from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train import state as jstate
from imfnet_tpu.train import step as jstep
from imfnet_tpu.train.trainer import Trainer as JaxTrainer

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.datasets import make_data_loader
from imfnet_tpu_torch.train.checkpoint import load_checkpoint
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.step import LOSS_FNS, make_accum_steps
from imfnet_tpu_torch.train.trainer import (MetricsWriter, Trainer, batch_to_device,
                                            build_model_from_config)
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers a thread pool per process oversubscribes the cores,
    and its barriers then cost far more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(make, out_dir, **kw):
    """The size of ``tests/test_trainer_dp.py::_dp_config`` on one device
    with one pair a batch (at two the reference's positive search is noise
    for the second pair, so its losses cannot be compared)."""
    base = dict(dataset="SyntheticPairDataset", synthetic_length=4, synthetic_n_points=400,
                batch_size=1, max_points=1024, voxel_size=0.05, conv1_kernel_size=3,
                model_n_out=16, num_pos_per_batch=64, num_hn_samples_per_batch=32,
                compute_dtype="float32", data_parallel=1, max_epoch=2, out_dir=str(out_dir),
                use_random_rotation=False, stat_freq=1, val_max_iter=2, lr=0.05)
    base.update(kw)
    return make(**base)


def _trainer(out_dir, val=True, **kw):
    cfg = _config(threedmatch_config, out_dir, **kw)
    tl = make_data_loader(cfg, "train", cfg.batch_size)
    vl = make_data_loader(cfg, "val", cfg.val_batch_size) if val else None
    return Trainer(cfg, tl, vl, device="cpu")


def _scalars(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _by_tag(out_dir):
    out = collections.defaultdict(list)
    for rec in _scalars(out_dir):
        out[rec["tag"]].append((rec["step"], rec["value"]))
    return dict(out)


def _checkpoints(out_dir):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(out_dir, "*checkpoint*")))


# ---- structure against the JAX Trainer ---------------------------------------

VAL_KEYS = ("loss", "rre", "rte", "success", "hit_ratio", "feat_match_ratio",
            "corr_inliers", "irls_resid_med", "irls_resid_inlier")


class _Script:
    """The same scripted step results for both trainers: training losses
    count up, validation epoch e (0 = the one before training) reports
    ``vals[e]`` for the gated metric on every batch, NaN RRE on its first."""

    def __init__(self, metric, vals, val_iters):
        self.metric, self.vals, self.val_iters = metric, vals, val_iters
        self.train_calls = self.val_calls = 0

    def train_metrics(self):
        self.train_calls += 1
        x = float(self.train_calls)
        return {"loss": x, "pos_loss": x / 4, "neg_loss": 3 * x / 4}

    def val_metrics(self):
        epoch, i = divmod(self.val_calls, self.val_iters)
        self.val_calls += 1
        out = {k: 0.125 * (n + 1) for n, k in enumerate(VAL_KEYS)}
        out[self.metric] = self.vals[epoch]
        if i == 0 and self.metric != "rre":
            out["rre"] = float("nan")
        return out


def _run_scripted(tmp_path, metric, vals, **kw):
    kw = dict(dict(max_epoch=3, best_val_metric=metric), **kw)
    val_iters = 2
    # the JAX trainer: its own loop, scripted steps, a small stand-in state
    jcfg = _config(jax_config, tmp_path / "jax", **kw)
    jt = JaxTrainer(jcfg, jax_make_data_loader(jcfg, "train", 1),
                    jax_make_data_loader(jcfg, "val", 1))
    js = _Script(metric, vals, val_iters)
    jt.state = jstate.create_train_state(
        {"params": {"w": jnp.zeros(3)}, "batch_stats": {}}, jt.tx)
    jt.train_step = lambda state, batch, key: (state, js.train_metrics())
    jt.val_step = lambda params, stats, batch, key: js.val_metrics()
    jt.train()
    jt.writer.close()
    # the port's
    pt = _trainer(tmp_path / "port", **kw)
    ps = _Script(metric, vals, val_iters)
    pt.init_state()
    pt.train_step = lambda state, batch, gen: (state, ps.train_metrics())
    pt.val_step = lambda batch, gen: ps.val_metrics()
    pt.train()
    pt.writer.close()
    assert ps.train_calls == js.train_calls and ps.val_calls == js.val_calls
    return jt, pt


@pytest.mark.parametrize("metric,vals,best_epoch", [
    ("feat_match_ratio", [0.0, 0.5, 0.5, 0.25], 1),     # a tie: the first stays
    ("feat_match_ratio", [0.0, 0.25, 0.5, 0.5], 2),
    ("rre", [9.0, 4.0, 2.0, 2.0], 2),                   # a min metric, and a tie
    ("success", [1.0, 0.0, 0.0, 0.0], 1),               # epoch 0 is never the best
])
def test_loop_structure_equals_the_jax_trainer(tmp_path, metric, vals, best_epoch):
    jt, pt = _run_scripted(tmp_path, metric, vals)
    jdir, pdir = jt.out_dir, pt.out_dir
    assert _scalars(pdir) == _scalars(jdir)             # tags, order, steps, values
    tags = _by_tag(pdir)
    assert [s for s, _ in tags["train/loss"]] == list(range(12))   # 3 epochs of 4
    assert [s for s, _ in tags["val/" + metric]] == [0, 1, 2, 3]
    assert len(tags) == 3 + len(VAL_KEYS)
    assert _checkpoints(pdir) == _checkpoints(jdir)
    assert len(_checkpoints(pdir)) == 3 + len({v for v in vals[1:best_epoch + 1]})
    assert pt.best_val_epoch == jt.best_val_epoch == best_epoch
    assert pt.best_val == jt.best_val == vals[best_epoch]
    for name in _checkpoints(pdir):
        with open(os.path.join(pdir, name, "meta.json")) as a, \
                open(os.path.join(jdir, name, "meta.json")) as b:
            ma, mb = json.load(a), json.load(b)
        ma["config"].pop("out_dir"), mb["config"].pop("out_dir")
        assert ma == mb, name
    with open(os.path.join(pdir, "config.json")) as a, open(os.path.join(jdir, "config.json")) as b:
        assert a.read().replace("/port", "/jax") == b.read()


def test_val_epoch_freq_stat_freq_and_no_first_validation(tmp_path):
    jt, pt = _run_scripted(tmp_path, "feat_match_ratio", [0.5, 0.25], max_epoch=3,
                           val_epoch_freq=2, test_valid=False, stat_freq=3)
    assert _scalars(pt.out_dir) == _scalars(jt.out_dir)
    tags = _by_tag(pt.out_dir)
    assert [s for s, _ in tags["train/loss"]] == [0, 3, 4, 7, 8, 11]   # iterations 0 and 3
    assert [s for s, _ in tags["val/loss"]] == [2]
    assert _checkpoints(pt.out_dir) == _checkpoints(jt.out_dir) == [
        "best_val_checkpoint_epoch_2_feat_match_ratio_0.5",
        "checkpoint_epoch_2_feat_match_ratio_0.5"]


def test_no_validation_loader_writes_no_checkpoint(tmp_path):
    pt = _trainer(tmp_path, val=False, max_epoch=1)
    pt.init_state()
    pt.train_step = lambda state, batch, gen: (state, {"loss": 1.0})
    pt.train()
    assert _checkpoints(pt.out_dir) == [] and set(_by_tag(pt.out_dir)) == {"train/loss"}


def test_a_starved_epoch_is_refused_as_in_the_reference(tmp_path):
    kw = dict(synthetic_length=2, iter_size=3)
    jcfg = _config(jax_config, tmp_path / "j", **kw)
    with pytest.raises(ValueError, match="no optimizer step"):
        JaxTrainer(jcfg, jax_make_data_loader(jcfg, "train", 1), None)
    with pytest.raises(ValueError, match="no optimizer step"):
        _trainer(tmp_path / "p", val=False, **kw)
    pt = _trainer(tmp_path / "p", val=False, synthetic_length=2, iter_size=2)
    assert pt.steps_per_epoch == 1
    pt.init_state()
    pt.data_loader = pt.data_loader.__class__(pt.data_loader.dataset, 4, 1024)   # no batch left
    with pytest.raises(ValueError, match="no optimizer step"):
        pt._train_epoch(1)


def test_metrics_writer_appends_json_lines(tmp_path):
    w = MetricsWriter(str(tmp_path))
    w.add_scalar("train/loss", torch.tensor(1.5), 3)
    w.close()
    w = MetricsWriter(str(tmp_path))
    w.add_scalar("val/rre", np.float32(2.0), 4)
    w.close()
    assert _scalars(str(tmp_path)) == [{"tag": "train/loss", "value": 1.5, "step": 3},
                                       {"tag": "val/rre", "value": 2.0, "step": 4}]


# ---- the first loss against the JAX loss function ----------------------------

def test_first_training_loss_matches_jax(tmp_path):
    """Same weights (flax variables through ``flax_weights``), the first
    batch of the same loader stream; every positive and every negative
    candidate enters the loss (the sample counts cover the pad size), so the
    draws do not matter. 1e-5, as ``test_torch_port_train.py`` pins the step.
    The JAX loss runs un-jitted on the search pyramid (the same tables as
    the grid's): compiling it for the CPU takes minutes."""
    kw = dict(num_pos_per_batch=1024, num_hn_samples_per_batch=1024, max_epoch=1,
              synthetic_length=2)
    jcfg = _config(jax_config, tmp_path / "jax", use_grid_maps=False, **kw)
    jt = JaxTrainer(jcfg, jax_make_data_loader(jcfg, "train", 1), None)
    first = next(iter(jt.data_loader))
    sv = JaxSparseVoxels(first.coords0, first.feats0, first.n0)
    pyr = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, conv1_kernel_size=3, level_capacity=jstep.level_capacities(1024)))(
            first.coords0, first.n0)
    variables = jax.jit(lambda s, p, i: jt.model.init(
        jax.random.PRNGKey(0), s, p, i, train=False))(sv, pyr, first.image0)
    with jax.disable_jit():
        _, (jmetrics, _) = jstep.make_loss_fn(jt.model, jcfg)(
            variables["params"], variables["batch_stats"], first, jax.random.PRNGKey(0))

    pt = _trainer(tmp_path / "port", val=False, **kw)
    assert pt.config.use_grid_maps
    pt.model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, dict(variables))))
    pt.init_state()
    pt.train()
    tags = _by_tag(pt.out_dir)
    assert set(tags) == {"train/loss", "train/pos_loss", "train/neg_loss"}
    for k in ("loss", "pos_loss", "neg_loss"):
        assert tags[f"train/{k}"][0][0] == 0
        np.testing.assert_allclose(tags[f"train/{k}"][0][1], float(jmetrics[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert pt.state.step == 2 and np.isfinite([v for _, v in tags["train/loss"]]).all()


# ---- the port's own: accumulation, resume, loss kinds, devices ---------------

def _state_tensors(trainer):
    out = dict(trainer.state.model.state_dict())
    for i, s in trainer.state.optimizer.state_dict()["state"].items():
        out[f"momentum{i}"] = s["momentum_buffer"]
    return out


def test_iter_size_two_halves_the_optimizer_steps(tmp_path):
    pt = _trainer(tmp_path / "a", val=False, iter_size=2, max_epoch=1)
    pt.init_state()
    pt.train()
    assert pt.state.step == 2 and pt.steps_per_epoch == 2
    assert [s for s, _ in _by_tag(pt.out_dir)["train/loss"]] == [0, 1]

    # by hand: two grad_steps and one apply_step per group, on the same
    # batches, weights and generator stream
    cfg = pt.config
    state = create_train_state(build_model_from_config(cfg), cfg, steps_per_epoch=2)
    grad_step, apply_step = make_accum_steps(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    batches = list(make_data_loader(cfg, "train", 1))
    losses = []
    for g in range(2):
        ms = [grad_step(state, batch_to_device(b, torch.device("cpu")), gen)
              for b in batches[2 * g:2 * g + 2]]
        apply_step(state)
        losses.append(float(ms[0]["loss"] + ms[1]["loss"]) / 2)
    assert [v for _, v in _by_tag(pt.out_dir)["train/loss"]] == losses
    for (k, a), b in zip(pt.state.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    whole = _trainer(tmp_path / "whole", max_epoch=2, use_random_rotation=True)
    whole.init_state()
    whole.train()

    part = _trainer(tmp_path / "part", max_epoch=1, use_random_rotation=True)
    part.init_state()
    part.train()
    (ckpt,) = glob.glob(os.path.join(part.out_dir, "checkpoint_epoch_1_*"))
    rest = _trainer(tmp_path / "part", max_epoch=2, use_random_rotation=True, resume=ckpt,
                    test_valid=False)
    rest.init_state()
    assert rest.start_epoch == 2 and rest.state.step == 4
    # checkpoint_epoch_1 was written before epoch 1 was gated, as in the
    # reference: it knows the best of the epochs before it
    assert rest.best_val_epoch == -1
    rest.train()
    a, b = _state_tensors(whole), _state_tensors(rest)
    assert a.keys() == b.keys() and whole.state.step == rest.state.step == 8
    for k in a:
        assert torch.equal(a[k], b[k]), k      # parameters, buffers, momentum
    assert (whole.state.optimizer.param_groups[0]["lr"]
            == rest.state.optimizer.param_groups[0]["lr"])
    wl, rl = _by_tag(whole.out_dir)["train/loss"], _by_tag(rest.out_dir)["train/loss"]
    assert rl == wl                            # the appended log continues the same curve
    assert ([c for c in _checkpoints(rest.out_dir) if c.startswith("checkpoint")]
            == [c for c in _checkpoints(whole.out_dir) if c.startswith("checkpoint")])
    # and the checkpoint restores into a fresh state
    fresh = _trainer(tmp_path / "fresh", val=False)
    fresh.init_state()
    _, meta = load_checkpoint(ckpt, fresh.state)
    assert meta["epoch"] == 1 and fresh.state.step == 4


@pytest.mark.parametrize("kind", sorted(LOSS_FNS))
def test_every_loss_kind_takes_steps(tmp_path, kind):
    pt = _trainer(tmp_path, val=False, trainer=kind, synthetic_length=2, max_epoch=1,
                  triplet_num_pos=64, triplet_num_hn=64, triplet_num_rand=128)
    pt.init_state()
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    pt.train()
    losses = [v for _, v in _by_tag(pt.out_dir)["train/loss"]]
    assert len(losses) == 2 and np.isfinite(losses).all() and losses[0] != losses[1]
    assert pt.state.step == 2
    assert any(not torch.equal(v, before[k]) for k, v in pt.model.state_dict().items())


def test_device_and_data_parallel_rules(tmp_path, monkeypatch):
    """Without a mesh a Trainer has one device: data_parallel 2 is more than
    there are, 0 (auto) is 1. A mesh of two ranks takes data_parallel 2
    (``parallel.mesh.Mesh``; its constructor runs no collective)."""
    from imfnet_tpu_torch.parallel.mesh import Mesh

    cfg = _config(threedmatch_config, tmp_path)
    loader = make_data_loader(cfg, "train", 1)
    with pytest.raises(ValueError, match="devices are"):
        Trainer(cfg.replace(data_parallel=2), loader, device="cpu")
    assert Trainer(cfg.replace(data_parallel=0), loader, device="cpu").n_devices == 1
    two = Trainer(cfg.replace(data_parallel=2), make_data_loader(cfg, "train", 1),
                  mesh=Mesh(2, 1, torch.device("cpu"), None, "gloo"))
    assert two.n_devices == 2 and not two.is_main and two.data_loader.shard == (1, 2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, loader)


def test_validation_does_not_depend_on_the_training_stream(tmp_path):
    """The validation step of batch i draws from a generator seeded with i."""
    pt = _trainer(tmp_path, val_max_iter=2)
    pt.init_state()
    pt.val_data_loader.shuffle = False
    a = pt._valid_epoch()
    torch.rand(5, generator=pt.generator)      # the training stream moves on
    b = pt._valid_epoch()
    assert a == b and np.isfinite(a["loss"])
