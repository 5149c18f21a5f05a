"""Port parity, checkpoints: the directory contract of the JAX package (name,
``meta.json`` keys, ``format_version``), a bit-equal restore of module,
optimizer, scheduler and step count, the config read from a checkpoint
either package wrote, and the key migration."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.train import checkpoint as jckpt
from imfnet_tpu.train import state as jstate

from imfnet_tpu_torch.config import Config, threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.train import checkpoint as pckpt
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.step import make_train_step
from imfnet_tpu_torch.train.trainer import build_model_from_config

SMALL = dict(batch_size=1, conv1_kernel_size=3, model_n_out=16, num_pos_per_batch=64,
             num_hn_samples_per_batch=32, max_points=1024, voxel_size=0.05,
             compute_dtype="float32", lr=0.05)
ARGS = dict(epoch=3, best_val=0.25, best_val_epoch=2, best_val_metric="feat_match_ratio")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers a thread pool per process oversubscribes the cores,
    and its barriers then cost far more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state():
    """A small flax train state with an ``attention_fusion`` subtree."""
    params = {"attention_fusion": {"to_q": {"kernel": jnp.ones((4, 4)), "bias": jnp.zeros(4)},
                                   "norm": {"scale": jnp.ones(4)}},
              "conv1": {"kernel": jnp.ones((27, 1, 8))}}
    variables = {"params": params, "batch_stats": {"norm1": {"mean": jnp.zeros(8)}}}
    return jstate.create_train_state(variables, jstate.make_optimizer(jax_config(), 10))


@pytest.fixture(scope="module")
def trained():
    """A port train state after two steps (momentum buffers, a moved
    schedule, moved running statistics)."""
    cfg = threedmatch_config(**SMALL)
    batch = synthetic_batch(np.random.RandomState(0), batch_size=1, n_points=400,
                            n_pad=1024, voxel_size=0.05, image_hw=(24, 32), device="cpu")
    state = create_train_state(build_model_from_config(cfg), cfg, steps_per_epoch=1)
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, batch, gen)
    return cfg, state, batch


def _snapshot(state):
    return dict(model={k: v.clone() for k, v in state.model.state_dict().items()},
                momentum=[s["momentum_buffer"].clone()
                          for s in state.optimizer.state_dict()["state"].values()],
                lr=state.optimizer.param_groups[0]["lr"],
                sched=state.scheduler.last_epoch, step=state.step)


def test_save_perturb_load_restores_everything_bit_equal(trained, tmp_path):
    cfg, state, batch = trained
    path = pckpt.save_checkpoint(str(tmp_path), "checkpoint", state, cfg, val_value=0.5,
                                 extra={"note": 7, "t": torch.arange(3)}, **ARGS)
    want = _snapshot(state)
    assert want["step"] == 2 and want["sched"] == 2 and want["lr"] == pytest.approx(0.05 * 0.99 ** 2)

    other = create_train_state(build_model_from_config(cfg.replace(seed=5)), cfg,
                               steps_per_epoch=1)
    make_train_step(cfg)(other, batch, torch.Generator().manual_seed(9))   # perturbed
    assert not torch.equal(other.model.conv1.weight, state.model.conv1.weight)
    other, meta = pckpt.load_checkpoint(path, other)
    got = _snapshot(other)
    assert got["step"] == want["step"] and got["sched"] == want["sched"]
    assert got["lr"] == want["lr"]
    assert got["model"].keys() == want["model"].keys()
    for k in want["model"]:
        assert torch.equal(got["model"][k], want["model"][k]), k
    assert len(got["momentum"]) == len(want["momentum"]) > 50
    for a, b in zip(got["momentum"], want["momentum"]):
        assert torch.equal(a, b)
    assert meta["epoch"] == 3 and meta["extra"]["note"] == 7
    assert torch.equal(meta["extra"]["t"], torch.arange(3))
    # and the next step of both is the same step
    gen_a, gen_b = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    _, ma = make_train_step(cfg)(state, batch, gen_a)
    _, mb = make_train_step(cfg)(other, batch, gen_b)
    assert torch.equal(ma["loss"], mb["loss"])
    for (k, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("val_value", [None, 0.5, 0.0, 1.0 / 3.0])
def test_directory_name_and_meta_are_the_reference_ones(trained, tmp_path, val_value):
    cfg, state, _ = trained
    jcfg = jax_config(**SMALL)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), "best_val_checkpoint", _jax_state(),
                                  jcfg, val_value=val_value, **ARGS)
    ppath = pckpt.save_checkpoint(str(tmp_path / "p"), "best_val_checkpoint", state, cfg,
                                  val_value=val_value, **ARGS)
    assert os.path.basename(ppath) == os.path.basename(jpath)
    assert sorted(os.listdir(ppath)) == ["meta.json", "state.pt"]
    with open(os.path.join(jpath, "meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(ppath, "meta.json")) as f:
        pmeta = json.load(f)
    assert list(pmeta) == list(jmeta)
    assert pmeta == jmeta and pmeta["format_version"] == 1    # the configs are equal too


def test_config_from_a_checkpoint_of_either_package(trained, tmp_path):
    cfg, state, _ = trained
    jcfg = jax_config(level_capacity_divisors=(1, 3, 8, 20), **SMALL)
    jpath = jckpt.save_checkpoint(str(tmp_path), "jax", _jax_state(), jcfg, **ARGS)
    assert not os.path.exists(os.path.join(jpath, "state.pt"))
    got = pckpt.load_config_from_checkpoint(jpath)
    assert isinstance(got, Config)
    assert got == threedmatch_config(level_capacity_divisors=(1, 3, 8, 20), **SMALL)
    ppath = pckpt.save_checkpoint(str(tmp_path), "port", state, cfg, **ARGS)
    assert pckpt.load_config_from_checkpoint(ppath) == cfg
    assert jckpt.load_config_from_checkpoint(ppath).to_json() == cfg.to_json()


def test_migrate_checkpoint_keys_moves_what_the_reference_moves(trained, tmp_path):
    """The same rename (a module ``attention_fusion`` → ``perceiver_io``)
    moves as many tensors of a port checkpoint as leaves of a JAX one whose
    subtree has the same tensors (here 3: a kernel, a bias, a scale)."""
    cfg, state, _ = trained
    jpath = jckpt.save_checkpoint(str(tmp_path), "jax", _jax_state(), jax_config(), **ARGS)
    jmoved = jckpt.migrate_checkpoint_keys(
        jpath, str(tmp_path / "jax_out"), {"params/attention_fusion": "params/perceiver_io"})
    model = torch.nn.Module()
    model.attention_fusion = torch.nn.Module()
    model.attention_fusion.to_q = torch.nn.Linear(4, 4)
    model.attention_fusion.norm = torch.nn.LayerNorm(4, bias=False)
    model.attention_fusion_2 = torch.nn.Linear(2, 2, bias=False)   # a prefix, not a component
    small = create_train_state(model, cfg, steps_per_epoch=1)
    ppath = pckpt.save_checkpoint(str(tmp_path), "port", small, cfg, **ARGS)
    pmoved = pckpt.migrate_checkpoint_keys(
        ppath, str(tmp_path / "port_out"), {"attention_fusion": "perceiver_io"})
    assert pmoved == jmoved == 3
    blob = torch.load(str(tmp_path / "port_out" / "state.pt"), weights_only=True)
    assert sorted(blob["model"]) == ["attention_fusion_2.weight", "perceiver_io.norm.weight",
                                     "perceiver_io.to_q.bias", "perceiver_io.to_q.weight"]
    assert torch.equal(blob["model"]["perceiver_io.to_q.weight"],
                       model.attention_fusion.to_q.weight)
    with open(tmp_path / "port_out" / "meta.json") as f:
        assert json.load(f)["epoch"] == 3

    # on a real model: every tensor under the renamed module, nothing else
    full = pckpt.save_checkpoint(str(tmp_path), "full", state, cfg, **ARGS)
    n = sum(k.startswith("attention_fusion.") for k in state.model.state_dict())
    assert pckpt.migrate_checkpoint_keys(
        full, str(tmp_path / "full_out"), {"attention_fusion": "perceiver_io"}) == n > 0


def test_a_sparse_conv1_state_dict_loads_into_the_occupancy_model(trained):
    """Training runs conv1 as a sparse conv and inference as an occupancy
    product; the parameters and buffers are the same, so a trained
    ``state_dict`` loads into the model ``PairRegistrar`` builds."""
    cfg, state, _ = trained
    fast = build_model_from_config(cfg.replace(seed=3), eval_fast=True)
    assert fast.conv1_occupancy and not state.model.conv1_occupancy
    fast.load_state_dict(state.model.state_dict(), strict=True)
    assert torch.equal(fast.conv1.weight, state.model.conv1.weight)
