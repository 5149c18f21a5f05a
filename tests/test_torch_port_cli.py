"""The port's command line: ``train --dataset synthetic`` end to end on the
CPU at a small size, ``--resume-dir``, and the refusals (no card, more than
one device or process)."""
import argparse
import glob
import json
import os

import numpy as np
import pytest
import torch

from imfnet_tpu import cli as jcli

from imfnet_tpu_torch import cli
from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.train.checkpoint import load_checkpoint, load_config_from_checkpoint
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.trainer import build_model_from_config

SMALL = ["--dataset", "synthetic", "--batch-size", "1", "--lr", "0.05", "--voxel-size", "0.05",
         "--max-points", "1024", "--model-n-out", "16", "--conv1-kernel-size", "3",
         "--synthetic-length", "3", "--synthetic-n-points", "400"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers a thread pool per process oversubscribes the cores,
    and its barriers then cost far more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    return [(r["step"], r["value"]) for r in recs if r["tag"] == "train/loss"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    cli.main(["train", *SMALL, "--device", "cpu", "--max-epoch", "2", "--out-dir", out])
    return out


def test_train_writes_config_metrics_and_checkpoints(run_dir):
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    assert cfg.dataset == "SyntheticPairDataset" and cfg.max_points == 1024
    assert cfg.out_dir == run_dir and cfg.model_n_out == 16 and cfg.data_parallel == 1
    losses = _train_losses(run_dir)
    assert [s for s, _ in losses] == [0, 3] and np.isfinite([v for _, v in losses]).all()
    ckpts = sorted(glob.glob(os.path.join(run_dir, "checkpoint_epoch_*")))
    assert len(ckpts) == 2 and glob.glob(os.path.join(run_dir, "best_val_checkpoint_epoch_*"))
    assert load_config_from_checkpoint(ckpts[-1]) == cfg
    state = create_train_state(build_model_from_config(cfg.replace(seed=9)), cfg, 3)
    state, meta = load_checkpoint(ckpts[-1], state)
    assert state.step == 6 and meta["epoch"] == 2
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.05 * 0.99 ** 2)
    assert all(torch.isfinite(v).all() for v in state.model.state_dict().values())


def test_resume_dir_picks_the_last_checkpoint(run_dir):
    args = argparse.Namespace(
        dataset="3dmatch", resume_dir=run_dir, max_epoch=3, num_devices=None)
    cfg = cli._base_config(args)
    assert os.path.basename(cfg.resume).startswith("checkpoint_epoch_2_")
    assert cfg.dataset == "SyntheticPairDataset" and cfg.max_epoch == 3 and cfg.lr == 0.05
    args.resume = "elsewhere"
    assert cli._base_config(args).resume == "elsewhere"
    cli.main(["train", "--resume-dir", run_dir, "--device", "cpu", "--max-epoch", "3"])
    assert [s for s, _ in _train_losses(run_dir)] == [0, 3, 6]
    assert len(glob.glob(os.path.join(run_dir, "checkpoint_epoch_*"))) == 3


@pytest.mark.parametrize("dataset", ["3dmatch", "kitti", "synthetic"])
def test_base_config_equals_the_jax_cli(dataset):
    argv = ["train", "--dataset", dataset, "--lr", "0.03", "--max-epoch", "7", "--seed", "5",
            "--trainer", "TripletLossTrainer", "--num-devices", "0", "--out-dir", "o"]
    seen = {}
    for mod in (cli, jcli):
        orig = mod.cmd_train
        mod.cmd_train = lambda args, mod=mod: seen.__setitem__(mod, mod._base_config(args))
        try:
            mod.main(argv)
        finally:
            mod.cmd_train = orig
    assert seen[cli].to_json() == seen[jcli].to_json()


def test_train_refuses_without_a_card_and_beyond_one_device(tmp_path, monkeypatch):
    out = ["--out-dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="data_parallel"):
        cli.main(["train", *SMALL, "--device", "cpu", "--num-devices", "2", *out])
    with pytest.raises(NotImplementedError, match="one process"):
        cli.main(["train", *SMALL, "--device", "cpu", "--num-processes", "2",
                  "--process-id", "1", "--coordinator", "localhost:1234", *out])
    with pytest.raises(NotImplementedError, match="1.9"):
        cli.main(["train", "--dataset", "kitti", "--device", "cpu", *out])
    with pytest.raises(SystemExit):
        cli.main(["generate-desc"])          # not ported yet: not registered
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", *SMALL, *out])
