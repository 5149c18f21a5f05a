"""Command-line entry points (``imfnet_tpu.cli``).

Replaces the reference's training scripts (`train_3DMatch.py`,
`train_Kitti.py`) with a subcommand of one CLI:

  python -m imfnet_tpu_torch.cli train --dataset 3dmatch --threed-match-dir ...
  python -m imfnet_tpu_torch.cli train --dataset synthetic --device cpu ...

The run goes to the card unless ``--device cpu`` asks for the plain PyTorch
path, and raises without a card otherwise. The JAX package's other
subcommands (descriptor generation, the evaluators, the activation maps, the
offline tools) are not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys


def _base_config(args):
    from imfnet_tpu_torch.config import Config, kitti_config, threedmatch_config

    # --resume-dir re-reads a previous run's config.json to reconstruct the
    # flags (`train_3DMatch.py:77-82` contract), then resumes from its last
    # checkpoint unless --resume names one explicitly
    over = {}
    if args.dataset == "synthetic":
        over["dataset"] = "SyntheticPairDataset"
    if getattr(args, "num_devices", None) is not None:
        over["data_parallel"] = args.num_devices
    for k in ("threed_match_dir", "overlap_path", "kitti_root", "out_dir",
              "max_epoch", "batch_size", "lr", "voxel_size", "trainer",
              "max_points", "seed", "resume",
              "model", "model_n_out", "conv1_kernel_size",
              "synthetic_length", "synthetic_n_points"):
        v = getattr(args, k, None)
        if v is not None:
            over[k] = v

    resume_dir = getattr(args, "resume_dir", None)
    if resume_dir:
        with open(os.path.join(resume_dir, "config.json")) as f:
            base = Config.from_json(f.read())
        if "resume" not in over:
            ckpts = sorted(
                d for d in os.listdir(resume_dir)
                if d.startswith("checkpoint") and
                os.path.isdir(os.path.join(resume_dir, d)))
            if ckpts:
                over["resume"] = os.path.join(resume_dir, ckpts[-1])
        over.pop("dataset", None)  # the resumed config's dataset wins
        return base.replace(**over)

    preset = kitti_config if args.dataset == "kitti" else threedmatch_config
    return preset(**over)


def cmd_train(args):
    from imfnet_tpu_torch.data.datasets import make_data_loader
    from imfnet_tpu_torch.train.trainer import Trainer

    # one process on one device: the flags of the JAX package's multi-host
    # bring-up are accepted, and anything they would spread raises
    if (args.num_processes or 1) != 1 or (args.process_id or 0) != 0 or args.coordinator:
        raise NotImplementedError(
            "--num-processes/--process-id/--coordinator: the port trains in one "
            "process on one device until data parallelism is ported (ROADMAP 1.12)")
    config = _base_config(args)
    train_loader = make_data_loader(config, "train", config.batch_size)
    val_loader = make_data_loader(config, "val", config.val_batch_size)
    trainer = Trainer(config, train_loader, val_loader, device=args.device)
    logging.info("training on %s", trainer.device)
    trainer.init_state()
    trainer.train()


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(message)s",
        datefmt="%m/%d %H:%M:%S",
        stream=sys.stdout,
    )
    p = argparse.ArgumentParser(prog="imfnet-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train")
    pt.add_argument("--dataset", choices=["3dmatch", "kitti", "synthetic"],
                    default="3dmatch")
    for flag, typ in [("--threed-match-dir", str), ("--overlap-path", str),
                      ("--kitti-root", str), ("--out-dir", str),
                      ("--max-epoch", int), ("--batch-size", int),
                      ("--lr", float), ("--voxel-size", float),
                      ("--trainer", str), ("--max-points", int),
                      ("--seed", int), ("--resume", str),
                      ("--resume-dir", str),
                      # net group flags (`config_3dmatch.py:60-76`)
                      ("--model", str), ("--model-n-out", int),
                      ("--conv1-kernel-size", int),
                      ("--synthetic-length", int),
                      ("--synthetic-n-points", int)]:
        pt.add_argument(flag, type=typ, default=None,
                        dest=flag[2:].replace("-", "_"))
    pt.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; raises without "
                         "one). 'cpu' runs the plain PyTorch path")
    pt.add_argument("--num-devices", type=int, default=None,
                    dest="num_devices",
                    help="data-parallel size over the pair axis: 0 = auto, "
                         "1 = one device (default); more raises until data "
                         "parallelism is ported")
    pt.add_argument("--num-processes", type=int, default=None)
    pt.add_argument("--process-id", type=int, default=None)
    pt.add_argument("--coordinator", type=str, default=None)
    pt.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
