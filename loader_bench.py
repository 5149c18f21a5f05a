#!/usr/bin/env python3
"""The port's trainer fed by its loader in a worker process (``workers=1``)
and in a thread (``workers=0``), at full width on one NVIDIA GPU, with an
epoch long enough that the worker's start is a small part of it.

    python3 loader_bench.py [--steps 100] [--out FILE]

Each run is a new ``Trainer`` on ``SyntheticPairDataset`` (200 000 points
a fragment, 2 pairs a batch, 65 536 rows a side, ``bench_config``: the
ResUNetBN2C that ``chip_smoke.py``'s trainer phase trains) through
``make_data_loader(..., workers=w)``: one epoch of ``--steps`` steps, no
validation. A short run first builds the kernels and is not reported.
The runs go in the order 1, 0, 0, 1, so that a drift of the
card or the host falls on both. Each prints one JSON line: steps/s over the
whole run (the worker's start included) and after the first WARM steps,
the median step, the loader's wait per step after WARM and its share, the
move to the card. The last line sums each ``workers`` value's runs. Fails
unless every run's losses are bit-equal (the loader is host code: its
batches are the same). Needs one card."""
import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from imfnet_tpu_torch.data.datasets import make_data_loader
from imfnet_tpu_torch.pipeline import bench_config
from imfnet_tpu_torch.train.trainer import Trainer

WARM = 10              # steps left out of the steady rate (worker start, first shapes)
ORDER = (1, 0, 0, 1)   # workers of each run
BATCH, N_PAD, POINTS = 2, 65536, 200_000


class TimedTrainer(Trainer):
    """A Trainer that reads, for each step, the loader's wait, the step's
    time to completion on the card and the moment it completed."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.wait_s, self.step_ms, self.done, self.losses = [], [], [], []
        step = self.train_step

        def timed_step(state, batch, generator):
            t = time.perf_counter()
            out = step(state, batch, generator)
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.step_ms.append((now - t) * 1e3)
            self.done.append(now)
            self.losses.append(out[1]["loss"].detach().clone())
            return out

        self.train_step = timed_step

    def _next_batch(self, it):
        t = time.perf_counter()
        out = super()._next_batch(it)
        self.wait_s.append(time.perf_counter() - t)
        return out


def run(workers, steps, out_dir):
    cfg = bench_config().replace(
        batch_size=BATCH, dataset="SyntheticPairDataset", synthetic_n_points=POINTS,
        synthetic_length=BATCH * steps, max_points=N_PAD, max_epoch=1, stat_freq=steps,
        out_dir=out_dir)
    loader = make_data_loader(cfg, "train", cfg.batch_size, workers=workers)
    trainer = TimedTrainer(cfg, loader, None)
    trainer.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    done, wait = trainer.done, trainer.wait_s
    steady_s = done[-1] - done[WARM - 1]
    out = {"workers": workers, "steps": len(done), "seconds": seconds,
           "steps_per_s": len(done) / seconds,
           "steps_per_s_after_warm": (len(done) - WARM) / steady_s,
           "first_step_done_s": done[0] - t0,
           "step_ms_median": float(np.median(trainer.step_ms)),
           "step_ms_median_after_warm": float(np.median(trainer.step_ms[WARM:])),
           "wait_ms_mean_after_warm": float(np.mean(wait[WARM:])) * 1e3,
           "wait_share_after_warm": float(np.sum(wait[WARM:])) / steady_s,
           "move_ms": trainer.move_timer.avg * 1e3}
    return out, trainer.losses


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=100, help="steps of each run's epoch")
    parser.add_argument("--out", help="also write the JSON lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("loader_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.steps <= WARM:
        parser.error(f"--steps must exceed {WARM}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    with tempfile.TemporaryDirectory(prefix="loader_bench_") as out_dir:
        run(0, WARM + 1, out_dir)       # builds the kernels; not reported
    runs, losses = [], []
    for workers in ORDER:
        with tempfile.TemporaryDirectory(prefix="loader_bench_") as out_dir:
            r, ls = run(workers, args.steps, out_dir)
        emit(dict(r, nvidia_smi=smi))
        runs.append(r)
        losses.append(ls)
    equal = all(len(ls) == len(losses[0]) and all(torch.equal(a, b) for a, b in zip(ls, losses[0]))
                for ls in losses)
    summary = {}
    for w in sorted(set(ORDER)):
        mine = [r for r in runs if r["workers"] == w]
        summary[f"workers_{w}"] = {k: [r[k] for r in mine] for k in mine[0] if k != "workers"}
    emit({"summary": summary, "losses_bit_equal": equal, "nvidia_smi": smi})
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    if not equal:
        print("loader_bench: the runs' losses differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
