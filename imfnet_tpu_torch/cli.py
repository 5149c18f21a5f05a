"""Command-line entry points (``imfnet_tpu.cli``).

Replaces the reference's scripts (`train_3DMatch.py`, `train_Kitti.py`,
`scripts/generate_desc.py`, `scripts/evaluation_3dmatch.py`,
`scripts/evaluation_kitti.py`, `dam.py`, the `data/` tools) with the twelve
subcommands of the JAX package's CLI:

  python -m imfnet_tpu_torch.cli train --dataset 3dmatch --threed-match-dir ...
  python -m imfnet_tpu_torch.cli generate-desc --checkpoint ... --pcloud-root ...
  python -m imfnet_tpu_torch.cli eval-3dmatch --desc-root ... --benchmark 3DMatch
  python -m imfnet_tpu_torch.cli compare --desc-roots A=... B=... --benchmark-dir ...
  python -m imfnet_tpu_torch.cli convert-desc --desc-root ... --keypoint-root ...
  python -m imfnet_tpu_torch.cli eval-kitti --checkpoint ... --kitti-root ...
  python -m imfnet_tpu_torch.cli convert-imfnet --pth imfnet.pth --out ckpt
  python -m imfnet_tpu_torch.cli dam --checkpoint ... --ply ... --image ... --point 780
  python -m imfnet_tpu_torch.cli visualize --checkpoint ... --ply0 ... --ply1 ...
  python -m imfnet_tpu_torch.cli fuse-fragments --scene-dir ... --out-dir ...
  python -m imfnet_tpu_torch.cli compute-overlap --fragments-dir ... --out-dir ...
  python -m imfnet_tpu_torch.cli compute-radius --fragments-dir ...

Every run goes to the card unless ``--device cpu`` asks for the plain
PyTorch path, and raises without a card otherwise. ``train``,
``generate-desc`` and ``eval-kitti`` take ``--num-devices N`` (0: every
device): N > 1 starts N ranks, one process a device (``cuda:l`` for local
rank l, or the CPU with ``--device cpu``, over gloo), and
``--num-processes P --process-id p --coordinator host:port`` spreads them
over P processes (hosts), N/P each, process p holding global ranks
p·N/P onwards. ``--checkpoint`` names a
checkpoint directory the port wrote (``meta.json`` + ``state.pt``: ``train``
and ``convert-imfnet`` write them); the JAX package's flax msgpack state is
not read.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np


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
            from imfnet_tpu_torch.train.checkpoint import last_checkpoint

            last = last_checkpoint(resume_dir)
            if last:
                over["resume"] = last
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


def _available_devices(device_type: str) -> int:
    """Devices one host can give its ranks: the cards, or on the CPU its
    cores."""
    import torch

    return torch.cuda.device_count() if device_type == "cuda" else (os.cpu_count() or 1)


def _num_ranks(args, device_type: str) -> int:
    """``--num-devices`` (0: every device of every process's host)."""
    n = 1 if args.num_devices is None else args.num_devices
    return n if n else (args.num_processes or 1) * _available_devices(device_type)


def _rank_layout(args, n: int, device_type: str) -> dict:
    """spawn_ranks' keywords for this process's share of ``n`` ranks."""
    procs, pid = args.num_processes or 1, args.process_id or 0
    if not 0 <= pid < procs:
        raise ValueError(f"--process-id {pid} is not one of {procs} processes")
    if n % procs or n < procs:
        raise ValueError(f"--num-devices {n} does not split over --num-processes {procs}")
    local = n // procs
    avail = _available_devices(device_type)
    if local > avail:
        raise ValueError(f"--num-devices {n}: {local} ranks on this host but only {avail} "
                         f"devices are addressable")
    if procs > 1 and not args.coordinator:
        raise ValueError("--num-processes above 1 needs --coordinator host:port")
    init = None
    if args.coordinator:
        init = args.coordinator if "://" in args.coordinator else f"tcp://{args.coordinator}"
    devices = ["cpu" if device_type == "cpu" else f"cuda:{i}"
               for _ in range(procs) for i in range(local)]
    return dict(devices=devices, rank_offset=pid * local, hosts=procs, init_method=init)


def _spawn(args, fn, n: int, device_type: str, fn_args=()):
    """Runs ``fn(mesh, *fn_args)`` on this process's ranks; prints global
    rank 0's result as a JSON line when it returns one."""
    from imfnet_tpu_torch.parallel.mesh import spawn_ranks

    layout = _rank_layout(args, n, device_type)
    logging.info("%d ranks, %d in this process, on %s", n,
                 len(layout["devices"]) // layout["hosts"], layout["devices"][0])
    devices = layout.pop("devices")
    results = spawn_ranks(fn, devices, fn_args, **layout)
    if layout["rank_offset"] == 0 and results[0] is not None:
        print(json.dumps(results[0]))


def _device_type(args) -> str:
    from imfnet_tpu_torch.utils.device import resolve_device

    return resolve_device(args.device).type


def _generate_desc_rank(mesh, args):
    from imfnet_tpu_torch.eval.threedmatch import generate_descriptors

    model, config = _load_model_and_vars(args.checkpoint, mesh.device)
    return generate_descriptors(model, config, args.pcloud_root, args.out_root,
                                num_devices=mesh.world_size, mesh=mesh)


def cmd_generate_desc(args):
    from imfnet_tpu_torch.eval.threedmatch import generate_descriptors

    device_type = _device_type(args)
    n = _num_ranks(args, device_type)
    if n > 1 or (args.num_processes or 1) > 1:
        return _spawn(args, _generate_desc_rank, n, device_type, (args,))
    model, config = _load_model_and_vars(args.checkpoint, args.device)
    stats = generate_descriptors(model, config, args.pcloud_root, args.out_root)
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


def _eval_kitti(args, device, mesh=None):
    from imfnet_tpu_torch.data.datasets import make_data_loader
    from imfnet_tpu_torch.eval.kitti import evaluate_kitti

    model, config = _load_model_and_vars(args.checkpoint, device)
    if args.kitti_root:
        config = config.replace(kitti_root=args.kitti_root)
    loader = make_data_loader(config, "test", 1, shuffle=False, device=device)
    try:
        return evaluate_kitti(model, config, loader,
                              num_devices=1 if mesh is None else mesh.world_size, mesh=mesh)
    finally:
        loader.close()


def _split_lists():
    """Each dataset class's own split lists (``DATA_FILES``), which a rank
    process takes over from the process that started it."""
    from imfnet_tpu_torch.data.datasets import ALL_DATASETS

    return {cls.__name__: dict(cls.DATA_FILES) for cls in ALL_DATASETS
            if "DATA_FILES" in vars(cls)}


def _eval_kitti_rank(mesh, args, split_lists):
    from imfnet_tpu_torch.data.datasets import dataset_class

    for name, files in split_lists.items():
        dataset_class(name).DATA_FILES = files
    return _eval_kitti(args, mesh.device, mesh)


def cmd_eval_kitti(args):
    device_type = _device_type(args)
    n = _num_ranks(args, device_type)
    if n > 1 or (args.num_processes or 1) > 1:
        return _spawn(args, _eval_kitti_rank, n, device_type, (args, _split_lists()))
    print(json.dumps(_eval_kitti(args, args.device)))


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


def _train_rank(mesh, config):
    from imfnet_tpu_torch.parallel.dp import run_trainer

    return run_trainer(mesh, config)


def cmd_train(args):
    from imfnet_tpu_torch.data.datasets import make_data_loader
    from imfnet_tpu_torch.train.trainer import Trainer, resolve_data_parallel

    config = _base_config(args)
    procs = args.num_processes or 1
    if config.data_parallel != 1 or procs > 1:
        # the ranks to start: --num-devices 0 is every device there is,
        # clamped so that each epoch takes a step (the JAX Trainer's rule)
        device_type = _device_type(args)
        batches = len(make_data_loader(config, "train", config.batch_size, device=args.device))
        n = resolve_data_parallel(config, batches, procs * _available_devices(device_type))
        config = config.replace(data_parallel=n)
        if n > 1 or procs > 1:
            return _spawn(args, _train_rank, n, device_type, (config,))
    train_loader = make_data_loader(config, "train", config.batch_size, device=args.device)
    val_loader = make_data_loader(config, "val", config.val_batch_size, device=args.device)
    trainer = Trainer(config, train_loader, val_loader, device=args.device)
    logging.info("training on %s", trainer.device)
    trainer.init_state()
    trainer.train()


def cmd_convert_imfnet(args):
    """A released reference ``.pth`` → a port checkpoint directory
    (``state.pt`` + ``meta.json`` with the embedded config and
    ``converted_from``) that every other subcommand loads with
    ``--checkpoint``. The config comes from the ``.pth``'s own
    (`scripts/generate_desc.py:160-175`); the converted weights are loaded
    into the model on the device, strictly, before anything is written."""
    import torch

    from imfnet_tpu_torch.config import threedmatch_config
    from imfnet_tpu_torch.train.checkpoint import STATE_FILE
    from imfnet_tpu_torch.train.trainer import build_model_from_config
    from imfnet_tpu_torch.utils.device import resolve_device
    from imfnet_tpu_torch.utils.torch_weights import convert_imfnet_torch

    device = resolve_device(args.device)
    ckpt = torch.load(args.pth, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    ref_cfg = ckpt.get("config", None)
    over = {}
    if ref_cfg is not None:
        ref = dict(ref_cfg)
        for k in ("trainer", "model", "model_n_out", "conv1_kernel_size",
                  "normalize_feature", "dist_type", "best_val_metric",
                  "voxel_size", "batch_size", "bn_momentum", "lr",
                  "max_epoch", "weight_decay"):
            if k in ref and ref[k] is not None:
                over[k] = ref[k]
    if args.voxel_size is not None:
        over["voxel_size"] = args.voxel_size
    config = threedmatch_config(**over)

    state = convert_imfnet_torch(sd, conv1_kernel_size=config.conv1_kernel_size,
                                 depth=args.depth)
    model = build_model_from_config(config, eval_fast=True).to(device)
    model.load_state_dict(state, strict=True)
    n_params = sum(p.numel() for p in model.parameters())

    os.makedirs(args.out, exist_ok=True)
    torch.save(dict(model=state), os.path.join(args.out, STATE_FILE))
    meta = dict(
        epoch=int(ckpt.get("epoch", 0) or 0),
        best_val=float(ckpt.get("best_val", 0.0) or 0.0),
        best_val_epoch=int(ckpt.get("best_val_epoch", 0) or 0),
        best_val_metric=str(ckpt.get("best_val_metric", config.best_val_metric)),
        config=json.loads(config.to_json()),
        format_version=1,
        converted_from=os.path.abspath(args.pth),
    )
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps({"out": args.out, "num_params": n_params, "model": config.model,
                      "conv1_kernel_size": config.conv1_kernel_size}))


DAM_PAD = 1 << 15   # voxel rows of the dam subcommand's one fragment


def dam_inputs(config, points: np.ndarray, image: np.ndarray, device):
    """(sv, pyramid, image[1, H, W, 3], xyz_down) of one fragment as the dam
    subcommand builds them: raw points padded to their bucket, the grid
    quantizer (kernel C on the card) at ``DAM_PAD`` voxel rows, the pyramid
    the config asks for (``config.use_grid_maps``: the banded builder,
    kernel D). A fragment whose coarse levels overflow raises; the JAX
    command runs on the truncated pyramid."""
    import torch

    from imfnet_tpu_torch.eval.extract import pad_points_bucketed
    from imfnet_tpu_torch.sparse.grid import GridSpec, quantize_grid
    from imfnet_tpu_torch.sparse.kernel_map import coarse_levels_fit
    from imfnet_tpu_torch.train.step import default_map_impl, make_pyramid_fn

    raw, n_raw = pad_points_bucketed(points)
    xyz = torch.from_numpy(raw).to(device)
    spec = GridSpec(extent=tuple(config.grid_extent), num_batches=1)
    sv, _, xyz_down = quantize_grid(
        xyz, torch.ones((len(raw), 1), device=device),
        torch.arange(len(raw), device=device) < n_raw, config.voxel_size, DAM_PAD, spec,
        compact_impl="kernel")
    pyr = make_pyramid_fn(config, DAM_PAD, 1, map_impl=default_map_impl(config))(
        sv.coords, sv.num_valid)
    if not bool(coarse_levels_fit(pyr)):
        raise RuntimeError(f"dam: the fragment's coarse pyramid levels overflow their "
                           f"capacities at {DAM_PAD} rows")
    return sv, pyr, torch.from_numpy(image[None]).to(device), xyz_down


def cmd_dam(args):
    from imfnet_tpu_torch.dam.dam import (descriptor_activation_map, image_activation_map,
                                          save_dam_image_overlay, save_dam_ply)
    from imfnet_tpu_torch.geom.image import load_image, process_image
    from imfnet_tpu_torch.geom.ply import read_ply

    model, config = _load_model_and_vars(args.checkpoint, args.device)
    device = next(model.parameters()).device
    points = read_ply(args.ply)["points"].astype(np.float32)
    image = process_image(load_image(args.image), config.image_H, config.image_W)
    sv, pyr, img, xyz_down = dam_inputs(config, points, image, device)
    weights = descriptor_activation_map(model, sv, pyr, img, args.point)
    save_dam_ply(args.out, xyz_down.cpu().numpy(), weights.cpu().numpy(), int(sv.num_valid))
    print(f"DAM written to {args.out}")
    if args.image_out:
        sal = image_activation_map(model, sv, pyr, img, args.point)
        save_dam_image_overlay(args.image_out, image, sal.cpu().numpy())
        print(f"DAM image overlay written to {args.image_out}")


def cmd_visualize(args):
    from imfnet_tpu_torch.utils.visualization import visualize_pair_registration

    model, config = _load_model_and_vars(args.checkpoint, args.device)
    T, fitness = visualize_pair_registration(model, config, args.ply0, args.image0,
                                             args.ply1, args.image1, args.out_dir)
    print(f"fitness {fitness:.4f}; views in {args.out_dir}")
    print(np.array_str(T, precision=4))


def cmd_fuse_fragments(args):
    from imfnet_tpu_torch.data.offline import fuse_scene

    written = fuse_scene(
        args.scene_dir, args.out_dir, frames_per_fragment=args.frames_per_fragment,
        frame_step=args.frame_step, dims=(args.resolution,) * 3,
        cubic_size=args.cubic_size, depth_scale=args.depth_scale,
        depth_trunc=args.depth_trunc, device=args.device)
    print(json.dumps({"fragments": written}))


def cmd_compute_overlap(args):
    from imfnet_tpu_torch.data.offline import build_overlap_lists, voxel_down_sample_np
    from imfnet_tpu_torch.geom.ply import read_ply
    from imfnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    plys = sorted(f for f in os.listdir(args.fragments_dir)
                  if f.startswith("cloud_bin_") and f.endswith(".ply"))
    frags = []
    for f in plys:
        pts = read_ply(os.path.join(args.fragments_dir, f))["points"]
        # the reference caps inputs at about 300k points (`compute_overlap.py:101`)
        if len(pts) > args.max_points:
            pts = voxel_down_sample_np(pts, args.downsample_voxel)
        frags.append((f[:-len(".ply")], pts.astype(np.float32)))
    kept = build_overlap_lists(frags, args.out_dir, dist_thresh=args.dist_thresh,
                               min_overlap=args.min_overlap, device=device)
    print(json.dumps({"pairs": [[a, b, r] for a, b, r in kept]}))


def cmd_compute_radius(args):
    from imfnet_tpu_torch.data.offline import compute_radius
    from imfnet_tpu_torch.geom.ply import read_ply
    from imfnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    outs = []
    for f in sorted(os.listdir(args.fragments_dir)):
        if not f.endswith(".ply"):
            continue
        path = os.path.join(args.fragments_dir, f)
        radii = compute_radius(read_ply(path)["points"], nn_radius=args.nn_radius,
                               device=device)
        out = path[:-len(".ply")] + ".radius.npy"
        np.save(out, radii)
        outs.append(out)
    print(json.dumps({"radius_files": outs}))


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
                    help="data-parallel ranks over the pair axis: 0 = every "
                         "device (clamped to the loader), 1 = one device "
                         "(default), N = N ranks, one process a device")

    def processes_flags(parser):
        # ranks over several processes (hosts): N/P ranks each
        parser.add_argument("--num-processes", type=int, default=None)
        parser.add_argument("--process-id", type=int, default=None)
        parser.add_argument("--coordinator", type=str, default=None,
                            help="host:port (or a file:// URL) where the ranks meet")

    processes_flags(pt)
    pt.set_defaults(fn=cmd_train)

    def device_flag(parser):
        parser.add_argument("--device", type=str, default=None,
                            help="torch device (default: the card; raises without "
                                 "one). 'cpu' runs the plain PyTorch path")

    def devices_flag(parser):
        parser.add_argument("--num-devices", type=int, default=1,
                            help="ranks to spread the items over, one process a "
                                 "device (0 = every device)")
        processes_flags(parser)

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

    pci = sub.add_parser("convert-imfnet")
    pci.add_argument("--pth", required=True, help="released reference checkpoint (.pth)")
    pci.add_argument("--out", required=True, help="output checkpoint directory")
    pci.add_argument("--voxel-size", type=float, default=None)
    pci.add_argument("--depth", type=int, default=0,
                     help="fusion self-attention depth (IMFNet ships 0)")
    device_flag(pci)
    pci.set_defaults(fn=cmd_convert_imfnet)

    pv = sub.add_parser("visualize")
    pv.add_argument("--checkpoint", required=True)
    pv.add_argument("--ply0", required=True)
    pv.add_argument("--image0", default="")
    pv.add_argument("--ply1", required=True)
    pv.add_argument("--image1", default="")
    pv.add_argument("--out-dir", default="views")
    device_flag(pv)
    pv.set_defaults(fn=cmd_visualize)

    pd = sub.add_parser("dam")
    pd.add_argument("--checkpoint", required=True)
    pd.add_argument("--ply", required=True)
    pd.add_argument("--image", required=True)
    pd.add_argument("--point", type=int, default=780)
    pd.add_argument("--out", default="3D_head_map.ply")
    pd.add_argument("--image-out", default=None,
                    help="also write the image-side attribution overlay PNG")
    device_flag(pd)
    pd.set_defaults(fn=cmd_dam)

    pf = sub.add_parser("fuse-fragments")
    pf.add_argument("--scene-dir", required=True)
    pf.add_argument("--out-dir", required=True)
    pf.add_argument("--frames-per-fragment", type=int, default=50)
    pf.add_argument("--frame-step", type=int, default=1)
    pf.add_argument("--resolution", type=int, default=256)
    pf.add_argument("--cubic-size", type=float, default=6.0)
    pf.add_argument("--depth-scale", type=float, default=1000.0)
    pf.add_argument("--depth-trunc", type=float, default=6.0)
    device_flag(pf)
    pf.set_defaults(fn=cmd_fuse_fragments)

    po = sub.add_parser("compute-overlap")
    po.add_argument("--fragments-dir", required=True)
    po.add_argument("--out-dir", required=True)
    po.add_argument("--dist-thresh", type=float, default=0.075)
    po.add_argument("--min-overlap", type=float, default=0.3)
    po.add_argument("--max-points", type=int, default=300000)
    po.add_argument("--downsample-voxel", type=float, default=0.01)
    device_flag(po)
    po.set_defaults(fn=cmd_compute_overlap)

    pr = sub.add_parser("compute-radius")
    pr.add_argument("--fragments-dir", required=True)
    pr.add_argument("--nn-radius", type=float, default=0.1)
    device_flag(pr)
    pr.set_defaults(fn=cmd_compute_radius)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
