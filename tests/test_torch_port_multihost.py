"""Ranks over several processes: ``cli train --num-devices 2
--num-processes 2 --process-id {0,1} --coordinator`` (two processes of one
rank each, meeting at a file, as two hosts would at ``host:port``) against
one process starting both ranks (``--num-devices 2``): the checkpoints are
equal bit for bit. The ranks run on the CPU over gloo."""
import glob
import os
import subprocess
import sys

import pytest
import torch

from imfnet_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--dataset", "synthetic", "--device", "cpu", "--batch-size", "1", "--max-epoch", "1",
         "--lr", "0.05", "--voxel-size", "0.05", "--max-points", "1024", "--model-n-out", "16",
         "--conv1-kernel-size", "3", "--synthetic-length", "4", "--synthetic-n-points", "400"]


def _last_state(run_dir):
    ckpt = sorted(glob.glob(os.path.join(run_dir, "checkpoint_epoch_*")))[-1]
    return torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)


def test_two_processes_equal_one_process_of_two_ranks(tmp_path):
    one = str(tmp_path / "one")
    cli.main(["train", *SMALL, "--num-devices", "2", "--out-dir", one])
    two = str(tmp_path / "two")
    coordinator = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "imfnet_tpu_torch.cli", "train", *SMALL, "--num-devices", "2",
         "--num-processes", "2", "--process-id", str(p), "--coordinator", coordinator,
         "--out-dir", two], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    a, b = _last_state(one), _last_state(two)
    assert a["step"] == b["step"] == 2
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for s_a, s_b in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert torch.equal(s_a["momentum_buffer"], s_b["momentum_buffer"])
    for r in range(2):
        assert torch.equal(a["extra"]["rank_streams"][r]["generator"],
                           b["extra"]["rank_streams"][r]["generator"])


def test_process_flags_are_checked(tmp_path):
    out = ["--out-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="coordinator"):
        cli.main(["train", *SMALL, "--num-devices", "2", "--num-processes", "2",
                  "--process-id", "0", *out])
    with pytest.raises(ValueError, match="split"):
        cli.main(["train", *SMALL, "--num-devices", "3", "--num-processes", "2",
                  "--process-id", "0", "--coordinator", "localhost:1", *out])
    with pytest.raises(ValueError, match="process-id"):
        cli.main(["train", *SMALL, "--num-devices", "2", "--num-processes", "2",
                  "--process-id", "2", "--coordinator", "localhost:1", *out])
