"""The port's data-parallel trainer, case by case after
``tests/test_trainer_dp.py``, on gloo ranks on the CPU:

- ``cli train --num-devices 2 --device cpu`` runs the epochs, validates and
  writes checkpoints as one device does;
- the two ranks' Trainers end, bit for bit, where a one-process loop of
  ``make_emulated_dp_step`` over the same loader ends (its specification),
  and with the same parameters on both ranks;
- a mesh larger than the devices, or than the loader can feed, is refused;
  auto (``data_parallel=0``) clamps to the loader;
- the loader's shard partitions an epoch, ragged tail included, and
  ``make_data_loader`` shards the train split in a group of ranks;
- a DP run resumed from its checkpoint equals the uninterrupted one;
- a sample that the dataset rejects on one rank does not hang the ranks
  (fault 4: the sharded loader replaces it)."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from imfnet_tpu_torch import cli
from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data import datasets
from imfnet_tpu_torch.data.datasets import make_data_loader
from imfnet_tpu_torch.parallel import dp
from imfnet_tpu_torch.parallel.mesh import Mesh, spawn_ranks
from imfnet_tpu_torch.train.checkpoint import load_config_from_checkpoint
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.trainer import (Trainer, batch_to_device, build_model_from_config,
                                            resolve_data_parallel)

from test_torch_port_train import _one_torch_thread  # noqa: F401
from torch_port_rejecting import run_rejecting_trainer


def _dp_config(out_dir, **kw):
    base = dict(dataset="SyntheticPairDataset", synthetic_length=16, synthetic_n_points=400,
                batch_size=1, max_points=1024, voxel_size=0.05, conv1_kernel_size=3,
                model_n_out=16, num_pos_per_batch=64, num_hn_samples_per_batch=32,
                compute_dtype="float32", data_parallel=2, max_epoch=1, out_dir=str(out_dir),
                use_random_rotation=False, val_max_iter=1)
    base.update(kw)
    return threedmatch_config(**base)


def _fake_mesh(world, rank=0):
    """A mesh record without a process group: enough for the Trainer's
    constructor, which runs no collective."""
    return Mesh(world, rank, torch.device("cpu"), None, "gloo")


def test_cli_train_num_devices_2_end_to_end(tmp_path):
    run_dir = str(tmp_path / "run")
    cli.main(["train", "--dataset", "synthetic", "--num-devices", "2", "--device", "cpu",
              "--batch-size", "1", "--max-epoch", "2", "--lr", "0.05", "--voxel-size", "0.05",
              "--max-points", "1024", "--model-n-out", "16", "--conv1-kernel-size", "3",
              "--synthetic-length", "8", "--synthetic-n-points", "400", "--out-dir", run_dir])
    ckpts = sorted(glob.glob(os.path.join(run_dir, "checkpoint*")))
    assert [os.path.basename(c).split("_feat")[0] for c in ckpts] == [
        "checkpoint_epoch_1", "checkpoint_epoch_2"]
    assert glob.glob(os.path.join(run_dir, "best_val_checkpoint_*"))
    assert load_config_from_checkpoint(ckpts[-1]).data_parallel == 2
    losses = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for ln in f:
            rec = json.loads(ln)
            if rec["tag"] == "train/loss":
                losses.append(rec["value"])
    # 8 samples over 2 ranks: 4 steps an epoch, logged at stat_freq
    assert losses and np.isfinite(losses).all()
    # every rank's random streams ride in the checkpoint
    extra = torch.load(os.path.join(ckpts[-1], "state.pt"), weights_only=True)["extra"]
    assert len(extra["rank_streams"]) == 2
    assert not torch.equal(extra["rank_streams"][0]["generator"],
                           extra["rank_streams"][1]["generator"])


def _emulated_run(config, epochs):
    """The specification: one process, ``make_emulated_dp_step`` on batch
    pairs (2i, 2i + 1) of the unsharded loader, rank r's generator for
    device r."""
    loader = make_data_loader(config, "train", config.batch_size, device="cpu")
    model = build_model_from_config(config)
    state = create_train_state(model, config, steps_per_epoch=len(loader) // 2)
    gens = [dp.rank_generator(config.seed, d, "cpu") for d in range(2)]
    step = dp.make_emulated_dp_step(config, 2)
    for _ in range(epochs):
        batches = [batch_to_device(b, torch.device("cpu")) for b in loader]
        for i in range(len(batches) // 2):
            state, _ = step(state, batches[2 * i:2 * i + 2], gens)
    return dp.train_state_arrays(state), state.step


def _assert_equal_arrays(a, b, what):
    for part in ("model", "momentum"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), f"{what}: {part} {k}"


def test_trainer_dp_matches_sequential_emulation(tmp_path):
    config = _dp_config(tmp_path / "a", synthetic_length=4)
    ranks = spawn_ranks(dp.run_trainer, ["cpu", "cpu"], (config, None, True))
    assert [r["step"] for r in ranks] == [2, 2]       # 4 batches over 2 ranks
    _assert_equal_arrays(ranks[0], ranks[1], "rank 0 vs rank 1")
    want, steps = _emulated_run(config, epochs=1)
    assert steps == 2
    _assert_equal_arrays(ranks[0], want, "ranks vs emulation")


def test_trainer_rejects_oversized_mesh(tmp_path):
    config = _dp_config(tmp_path, synthetic_length=4, data_parallel=8)
    loader = make_data_loader(config, "train", config.batch_size)
    # 4 batches an epoch cannot feed 8 ranks
    with pytest.raises(ValueError, match="no optimizer step"):
        Trainer(config, loader, None, mesh=_fake_mesh(8))
    config = _dp_config(tmp_path, data_parallel=16)
    loader = make_data_loader(config, "train", config.batch_size)
    with pytest.raises(ValueError, match="devices are"):
        Trainer(config, loader, None, mesh=_fake_mesh(8))
    # without a mesh a process has one device
    with pytest.raises(ValueError, match="devices are"):
        Trainer(_dp_config(tmp_path, data_parallel=2), loader, None, device="cpu")
    with pytest.raises(NotImplementedError, match="iter_size"):
        Trainer(_dp_config(tmp_path, iter_size=2), make_data_loader(config, "train", 1), None,
                mesh=_fake_mesh(2))


def test_trainer_auto_clamps_to_loader(tmp_path):
    """data_parallel=0 takes every device but never starves an epoch: 4
    batches on 8 devices make 4 ranks (the CLI starts as many)."""
    config = _dp_config(tmp_path, synthetic_length=4, data_parallel=0)
    assert resolve_data_parallel(config, 4, 8) == 4
    assert resolve_data_parallel(config, 16, 8) == 8
    assert resolve_data_parallel(config.replace(iter_size=2), 16, 8) == 1
    loader = make_data_loader(config, "train", config.batch_size)
    assert Trainer(config, loader, None, mesh=_fake_mesh(4)).n_devices == 4
    assert Trainer(config, make_data_loader(config, "train", 1), None,
                   device="cpu").n_devices == 1
    # a mesh of more ranks than auto resolves to is refused: here each of
    # 8 ranks' shard of 4 batches is empty
    with pytest.raises(ValueError, match="no optimizer step"):
        Trainer(config, make_data_loader(config, "train", 1), None, mesh=_fake_mesh(8))
    four = _dp_config(tmp_path, synthetic_length=32, data_parallel=4)
    with pytest.raises(ValueError, match="mesh has 8"):
        Trainer(four, make_data_loader(four, "train", 1), None, mesh=_fake_mesh(8))


def test_pair_loader_shard_partitions_epoch():
    """shard=(rank, world, group) splits batch groups round-robin: the union
    over ranks is exactly the unsharded epoch, in global step order."""
    config = _dp_config("unused", synthetic_length=8)

    def t_gts(shard):
        loader = make_data_loader(config, "train", 1)
        loader.shard = shard
        return [b.T_gt[0].numpy() for b in loader]

    full = t_gts(None)
    r0, r1 = t_gts((0, 2, 2)), t_gts((1, 2, 2))
    assert len(full) == 8 and len(r0) == 4 and len(r1) == 4
    for a, b in zip(full, r0[0:2] + r1[0:2] + r0[2:4] + r1[2:4]):
        np.testing.assert_array_equal(a, b)
    # one batch a rank a step: step i of rank r takes batch 2i + r
    s0, s1 = t_gts((0, 2, 1)), t_gts((1, 2, 1))
    for i in range(4):
        np.testing.assert_array_equal(full[2 * i], s0[i])
        np.testing.assert_array_equal(full[2 * i + 1], s1[i])


def test_pair_loader_shard_ragged_tail_is_equalized():
    """A total not divisible by world·group gives every rank the same
    count: only complete rounds survive."""
    config = _dp_config("unused", synthetic_length=10)

    def count(shard):
        loader = make_data_loader(config, "train", 1)
        loader.shard = shard
        n = sum(1 for _ in loader)
        assert n == len(loader)
        return n

    assert count((0, 2, 2)) == count((1, 2, 2)) == 4
    assert count((0, 4, 1)) == count((3, 4, 1)) == 2


def test_make_data_loader_shards_the_train_split_in_a_group(monkeypatch):
    config = _dp_config("unused", synthetic_length=8)
    monkeypatch.setattr(datasets.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(datasets.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(datasets.dist, "get_rank", lambda: 1)
    assert make_data_loader(config, "train", 1).shard == (1, 2, 1)
    assert make_data_loader(config, "val", 1).shard is None
    assert make_data_loader(config, "test", 1).shard is None


# fault 4: rank 1's dataset rejects these indices (rank 0's none); with
# seed 0 and 8 pairs, rank 1 draws 7 and 0 of them in its first epoch, 7
# and 5 in its second
REJECTED_ON_RANK_1 = (0, 5, 7)


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One pair of rank processes for the resume runs below and fault 4's
    run: two epochs in one run, one epoch, a checkpoint and a resume for
    the second from the run's last checkpoint; then two epochs on a train
    split whose dataset rejects samples on rank 1."""
    tmp_path = tmp_path_factory.mktemp("ranks")
    first = _dp_config(tmp_path / "split", synthetic_length=4, max_epoch=1)
    calls = [(dp.run_trainer, (_dp_config(tmp_path / "whole", synthetic_length=4, max_epoch=2),
                               None, True)),
             (dp.run_trainer, (first, None, False)),
             (dp.run_trainer, (first.replace(max_epoch=2), None, True, first.out_dir)),
             (run_rejecting_trainer, (_dp_config(tmp_path / "rejecting", synthetic_length=8,
                                                 max_epoch=2),
                                      {0: (), 1: REJECTED_ON_RANK_1}))]
    return tmp_path, spawn_ranks(dp.run_calls, ["cpu", "cpu"], (calls,))


def test_dp_resume_equals_the_uninterrupted_run(rank_runs):
    """Two epochs in one run against one epoch, a checkpoint, and a resume
    for the second from the run's last checkpoint, the three runs in one
    pair of rank processes: every rank's parameters, buffers and momentum
    equal."""
    tmp_path, ranks = rank_runs
    whole, resumed = ([r[j][0] for r in ranks] for j in (0, 2))
    assert [r[1][0] for r in ranks] == [None, None]
    assert glob.glob(str(tmp_path / "split" / "checkpoint_epoch_1*"))
    assert [r["step"] for r in whole] == [r["step"] for r in resumed] == [4, 4]
    for r in range(2):
        _assert_equal_arrays(resumed[r], whole[r], f"rank {r}: resumed vs whole")


def test_a_sample_rejected_on_one_rank_does_not_hang_the_ranks(rank_runs):
    """Fault 4: rank 1's dataset rejects samples of its shard; its loader
    draws replacements, so both ranks take len(loader) steps an epoch and
    the run ends (before the repair rank 1 ran out of batches while rank 0
    waited in the all-reduce)."""
    _, ranks = rank_runs
    (steps0, per_epoch0, skips0, pairs0), (steps1, per_epoch1, skips1, pairs1) = (
        r[3][0] for r in ranks)
    assert per_epoch0 == per_epoch1 == 4
    assert steps0 == steps1 == 2 * 4
    assert pairs0 == pairs1 == [1] * (2 * 4)
    assert skips0 == 0 and skips1 > 0
