"""The port's command line: ``train --dataset synthetic`` end to end on the
CPU at a small size, ``--resume-dir``, the benchmark subcommands
(``generate-desc``, ``eval-3dmatch``, ``compare``, ``convert-desc``,
``eval-kitti``) from a port checkpoint, and the refusals (no card, more than
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
from imfnet_tpu_torch.config import Config, kitti_config, threedmatch_config
from imfnet_tpu_torch.data.datasets import KITTIPairDataset
from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.eval import threedmatch
from imfnet_tpu_torch.geom.ply import write_ply
from imfnet_tpu_torch.train.checkpoint import (load_checkpoint, load_config_from_checkpoint,
                                               save_checkpoint)
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.trainer import build_model_from_config

from test_torch_port_kitti import write_kitti_root

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


def _subcommands(parser_main):
    """The subcommand names of a CLI's parser, read by letting its
    ``--help`` exit."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        parser_main(["--help"])
    text = buf.getvalue()
    return set(text[text.index("{") + 1:text.index("}")].split(","))


def test_the_cli_has_the_jax_cli_subcommands():
    names = _subcommands(cli.main)
    assert names == _subcommands(jcli.main) and len(names) == 12
    assert {"convert-imfnet", "dam", "visualize", "fuse-fragments", "compute-overlap",
            "compute-radius"} <= names


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
    # the KITTI datasets are ported: with no scans under --kitti-root the
    # loader finds none
    with pytest.raises(AssertionError, match="no velodyne data"):
        cli.main(["train", "--dataset", "kitti", "--device", "cpu",
                  "--kitti-root", str(tmp_path), *out])
    with pytest.raises(SystemExit):
        cli.main(["generate-desc"])          # --checkpoint and the roots are required
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", *SMALL, *out])


# ---- the benchmark subcommands ---------------------------------------------

SCENE = "7-scenes-redkitchen"
TINY = dict(conv1_kernel_size=3, model_n_out=16, compute_dtype="float32",
            image_H=24, image_W=32, num_rand_keypoints=256, ransac_max_iteration=4096)


def _checkpoint(out_dir, config):
    """A checkpoint the port's trainer would write, of a tiny model."""
    model = build_model_from_config(config)
    return save_checkpoint(str(out_dir), "checkpoint", create_train_state(model, config, 1),
                           config, 1, 0.0, 1, config.best_val_metric)


def _json_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _write_scene(root):
    """Three PLY fragments of one scene (4 000 points each, the synthetic
    pair's geometry), gt.log and gt.info for pairs (0, 1) and (1, 2)."""
    scene_dir = root / "pcloud" / SCENE / "seq-01"
    bench = root / "bench" / SCENE
    os.makedirs(scene_dir)
    os.makedirs(bench)
    for k in range(3):
        pair = synthetic_pair(np.random.RandomState(k), n_points=4000, image_hw=(24, 32))
        write_ply(str(scene_dir / f"cloud_bin_{k}.ply"), pair.xyz0)
    with open(bench / "gt.log", "w") as flog, open(bench / "gt.info", "w") as finfo:
        for i, j in [(0, 1), (1, 2)]:
            flog.write(f"{i} {j} 3\n" + "\n".join("\t".join(f"{v:.6f}" for v in r)
                                                   for r in np.eye(4)) + "\n")
            finfo.write(f"{i} {j} 3\n" + "\n".join("\t".join(f"{v:.6f}" for v in r)
                                                    for r in np.eye(6) * 400) + "\n")


def test_benchmark_subcommands_on_the_cpu(tmp_path, monkeypatch, capsys):
    """generate-desc → eval-3dmatch → compare → convert-desc from a port
    checkpoint, each printing its JSON; --num-devices 2 and a missing card
    raise."""
    monkeypatch.setattr(threedmatch, "TEST_SCENE_NAMES", [SCENE])
    _write_scene(tmp_path)
    ckpt = _checkpoint(tmp_path / "run", threedmatch_config(**TINY))
    desc = tmp_path / "desc"
    common = ["--checkpoint", ckpt, "--pcloud-root", str(tmp_path / "pcloud"),
              "--out-root", str(desc)]
    cli.main(["generate-desc", *common, "--device", "cpu"])
    (stats,) = _json_lines(capsys)
    assert stats["count"] == 3 and set(stats) == {"all_time", "avg_time", "count"}
    d = np.load(desc / SCENE / "seq-01" / "cloud_bin_0.npz")
    assert d["feature"].shape[1] == 16 and len(d["xyz"]) == len(d["feature"]) > 1000

    cli.main(["eval-3dmatch", "--checkpoint", ckpt, "--desc-root", str(desc),
              "--out-root", str(tmp_path / "eval"), "--benchmark-dir", str(tmp_path / "bench"),
              "--device", "cpu"])
    summary = _json_lines(capsys)[-1]
    assert summary["num_pairs"] == 2 and summary["benchmark"] == "bench"
    assert {"FMR", "registration_recall", "RRE", "RTE", "inlier_ratio"} <= set(summary)

    cli.main(["compare", "--desc-roots", f"A={desc}", f"B={desc}", "--benchmark-dir",
              str(tmp_path / "bench"), "--out-root", str(tmp_path / "cmp"), "--device", "cpu"])
    cmp = _json_lines(capsys)[-1]
    assert set(cmp["per_method"]) == {"A", "B"} and os.path.exists(cmp["csv"])

    ext, kp = tmp_path / "ext" / SCENE, tmp_path / "kp" / SCENE
    os.makedirs(ext)
    os.makedirs(kp)
    np.save(ext / "cloud_bin_0.desc.SpinNet.bin.npy", d["feature"])
    np.save(kp / "cloud_bin_0_keypts.npy", d["xyz"])
    cli.main(["convert-desc", "--desc-root", str(tmp_path / "ext"), "--keypoint-root",
              str(tmp_path / "kp"), "--out-root", str(tmp_path / "conv")])
    assert _json_lines(capsys) == [{"written": 1}]

    with pytest.raises(NotImplementedError, match="1.12"):
        cli.main(["generate-desc", *common, "--device", "cpu", "--num-devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["generate-desc", *common])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["eval-3dmatch", "--desc-root", str(desc), "--out-root",
                  str(tmp_path / "eval2"), "--benchmark-dir", str(tmp_path / "bench")])


def test_eval_kitti_subcommand_on_the_cpu(tmp_path, monkeypatch, capsys):
    root = write_kitti_root(tmp_path / "kitti")
    monkeypatch.setitem(KITTIPairDataset.DATA_FILES, "test", str(root / "test_list.txt"))
    cfg = kitti_config(dataset="KITTIPairDataset", max_points=4096, kitti_max_time_diff=3,
                       **TINY)
    ckpt = _checkpoint(tmp_path / "run", cfg)
    cli.main(["eval-kitti", "--checkpoint", ckpt, "--kitti-root", str(root), "--device", "cpu"])
    result = _json_lines(capsys)[-1]
    assert result["num_pairs"] == 2 and result["failed_loads"] == 0
    assert 0.0 <= result["success_rate"] <= 1.0
    with pytest.raises(NotImplementedError, match="1.12"):
        cli.main(["eval-kitti", "--checkpoint", ckpt, "--kitti-root", str(root),
                  "--device", "cpu", "--num-devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["eval-kitti", "--checkpoint", ckpt, "--kitti-root", str(root)])
