"""Command-line entry points (``imfnet_tpu.cli``).

Replaces the reference's scripts (`train_3DMatch.py`, `train_Kitti.py`,
`scripts/generate_desc.py`, `scripts/evaluation_3dmatch.py`,
`scripts/evaluation_kitti.py`) with subcommands of one CLI:

  python -m imfnet_tpu_torch.cli train --dataset 3dmatch --threed-match-dir ...
  python -m imfnet_tpu_torch.cli generate-desc --checkpoint ... --pcloud-root ...
  python -m imfnet_tpu_torch.cli eval-3dmatch --desc-root ... --benchmark 3DMatch
  python -m imfnet_tpu_torch.cli compare --desc-roots A=... B=... --benchmark-dir ...
  python -m imfnet_tpu_torch.cli convert-desc --desc-root ... --keypoint-root ...
  python -m imfnet_tpu_torch.cli eval-kitti --checkpoint ... --kitti-root ...

Every run goes to the card unless ``--device cpu`` asks for the plain
PyTorch path, and raises without a card otherwise. ``--checkpoint`` names a
checkpoint directory the port wrote (``meta.json`` + ``state.pt``); the JAX
package's flax msgpack state is not read. The JAX package's other
subcommands (the activation maps, the offline tools, the weight converter,
the visualizer) are not ported yet.
"""
from __future__ import annotations

import argparse
import json
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


def _load_model_and_vars(checkpoint: str, device=None):
    """(model, config): the model rebuilt from a port checkpoint's embedded
    config (`scripts/generate_model.py:28-62` contract) with its weights,
    in ``eval()`` on ``device`` (default the card). The model takes the
    inference path of conv1 (occupancy), which gives the same descriptors
    from the same parameters."""
    from imfnet_tpu_torch.train.checkpoint import load_model_from_checkpoint
    from imfnet_tpu_torch.utils.device import resolve_device

    return load_model_from_checkpoint(checkpoint, resolve_device(device))


def cmd_generate_desc(args):
    from imfnet_tpu_torch.eval.threedmatch import generate_descriptors

    model, config = _load_model_and_vars(args.checkpoint, args.device)
    stats = generate_descriptors(model, config, args.pcloud_root, args.out_root,
                                 num_devices=args.num_devices)
    print(json.dumps(stats))


def cmd_eval_3dmatch(args):
    from imfnet_tpu_torch.eval.threedmatch import evaluate
    from imfnet_tpu_torch.train.checkpoint import load_config_from_checkpoint

    config = (load_config_from_checkpoint(args.checkpoint) if args.checkpoint
              else _base_config(args))
    summary = evaluate(
        config, args.desc_root, args.out_root, args.benchmark_dir,
        desc_type=args.desc_type, keypoints_root=args.keypoints_root,
        use_saved_keypoints=args.use_saved_keypoints or None,
        benchmark=args.benchmark, device=args.device)
    print(json.dumps(summary))


def cmd_eval_kitti(args):
    from imfnet_tpu_torch.data.datasets import make_data_loader
    from imfnet_tpu_torch.eval.kitti import evaluate_kitti

    model, config = _load_model_and_vars(args.checkpoint, args.device)
    if args.kitti_root:
        config = config.replace(kitti_root=args.kitti_root)
    loader = make_data_loader(config, "test", 1, shuffle=False, device=args.device)
    print(json.dumps(evaluate_kitti(model, config, loader, num_devices=args.num_devices)))


def cmd_compare(args):
    from imfnet_tpu_torch.eval.compare import compare_methods

    roots = {}
    for spec in args.desc_roots:
        name, _, path = spec.partition("=")
        roots[name] = path
    config = _base_config(args)
    summary = compare_methods(
        roots, args.benchmark_dir, args.out_root, config,
        scenes=args.scenes or None, keypoints_root=args.keypoints_root,
        device=args.device)
    print(json.dumps({k: v for k, v in summary.items() if k != "views"}))


def cmd_convert_desc(args):
    from imfnet_tpu_torch.eval.compare import convert_external_descriptors

    out = convert_external_descriptors(
        args.desc_root, args.keypoint_root, args.out_root,
        keypoint_replace=(args.desc_infix, args.keypoint_infix))
    print(json.dumps({"written": len(out)}))


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
    train_loader = make_data_loader(config, "train", config.batch_size, device=args.device)
    val_loader = make_data_loader(config, "val", config.val_batch_size, device=args.device)
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

    def device_flag(parser):
        parser.add_argument("--device", type=str, default=None,
                            help="torch device (default: the card; raises without "
                                 "one). 'cpu' runs the plain PyTorch path")

    def devices_flag(parser):
        parser.add_argument("--num-devices", type=int, default=1,
                            help="devices to spread over; only 1 until data "
                                 "parallelism is ported")

    pg = sub.add_parser("generate-desc")
    pg.add_argument("--checkpoint", required=True)
    pg.add_argument("--pcloud-root", required=True)
    pg.add_argument("--out-root", required=True)
    devices_flag(pg)
    device_flag(pg)
    pg.set_defaults(fn=cmd_generate_desc)

    pe = sub.add_parser("eval-3dmatch")
    pe.add_argument("--checkpoint", default=None)
    pe.add_argument("--dataset", default="3dmatch")
    pe.add_argument("--desc-root", required=True)
    pe.add_argument("--out-root", required=True)
    pe.add_argument("--benchmark-dir", required=True)
    pe.add_argument("--benchmark", choices=["3DMatch", "3DLoMatch"], default=None,
                    help="fixture set; selects <benchmark-dir>/<benchmark> when "
                         "benchmark-dir is a fixtures root "
                         "(`evaluation_3dmatch.py:272,582`); default infers the "
                         "label from benchmark-dir itself")
    pe.add_argument("--desc-type", default="IMFNet")
    pe.add_argument("--keypoints-root", default=None,
                    help="folder of per-pair keypoint npz caches (default "
                         "<out-root>/<desc-type>_keypoints)")
    pe.add_argument("--use-saved-keypoints", action="store_true",
                    help="replay cached keypoint indices instead of sampling "
                         "(reference cfg.keypoints)")
    device_flag(pe)
    pe.set_defaults(fn=cmd_eval_3dmatch)

    pk = sub.add_parser("eval-kitti")
    pk.add_argument("--checkpoint", required=True)
    pk.add_argument("--kitti-root", default=None)
    devices_flag(pk)
    device_flag(pk)
    pk.set_defaults(fn=cmd_eval_kitti)

    pc = sub.add_parser("compare")
    pc.add_argument("--dataset", default="3dmatch")
    pc.add_argument("--desc-roots", nargs="+", required=True, metavar="NAME=PATH",
                    help="first entry is the primary method")
    pc.add_argument("--benchmark-dir", required=True)
    pc.add_argument("--out-root", required=True)
    pc.add_argument("--scenes", nargs="*", default=None)
    pc.add_argument("--keypoints-root", default=None,
                    help="externally-provided keypoint caches shared by all "
                         "methods (default: sampled by the primary method)")
    device_flag(pc)
    pc.set_defaults(fn=cmd_compare)

    pcd = sub.add_parser("convert-desc")
    pcd.add_argument("--desc-root", required=True)
    pcd.add_argument("--keypoint-root", required=True)
    pcd.add_argument("--out-root", required=True)
    pcd.add_argument("--desc-infix", default=".desc.SpinNet.bin")
    pcd.add_argument("--keypoint-infix", default="_keypts")
    pcd.set_defaults(fn=cmd_convert_desc)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
