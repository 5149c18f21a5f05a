"""3DMatch / 3DLoMatch benchmark pipeline (``imfnet_tpu.eval.threedmatch``).

Descriptor generation (`scripts/generate_desc.py:44-190`) and evaluation
(`scripts/evaluation_3dmatch.py:239-498`). The per-pair work (feature NN
both ways through kernel B, RANSAC, RR/RRE/RTE/IR, mutual-NN FMR stats) is
``eval.registration.make_keypoint_registration`` on the device. Artifact
contracts are kept: descriptors as `.npz{points, xyz, feature}`, per-scene
result json/txt, keypoint caches, the metrics CSV, the summary JSON and the
printed FMR/RR/RRE/RTE/IR summary. Scene lists follow
`scripts/evaluation_3dmatch.py:36-56`.

Descriptor generation shards over ranks (``num_devices`` > 1 with this
rank's ``mesh``: ``cli generate-desc --num-devices`` starts them). The
RANSAC draws of pair ``k`` come from a ``torch.Generator`` seeded with ``k``
where the JAX package passes ``PRNGKey(k)``; a caller can pass its own
``register``.
"""
from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.eval.extract import (RAW_BUCKETS, make_bucketed_extractor,
                                           pad_points_bucketed)
from imfnet_tpu_torch.eval.registration import make_keypoint_registration
from imfnet_tpu_torch.geom.image import load_image, process_image
from imfnet_tpu_torch.geom.ply import read_ply
from imfnet_tpu_torch.geom.trajectory import read_info_file, read_log
from imfnet_tpu_torch.utils.device import resolve_device
from imfnet_tpu_torch.utils.hashing import voxel_key_rows

TEST_SCENE_NAMES = [
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]

TEST_SCENE_ABBR_NAMES = [
    "Kitchen", "Home_1", "Home_2", "Hotel_1", "Hotel_2", "Hotel_3",
    "Study", "MIT_Lab",
]


def list_fragments(scene_dir: str) -> List[str]:
    names = [f[:-4] for f in os.listdir(scene_dir) if f.endswith(".ply")]

    def keyfn(n):
        try:
            return int(n.split("_")[-1])
        except ValueError:
            return 0

    return sorted(names, key=keyfn)


def generate_descriptors(
    model: torch.nn.Module,
    config: Config,
    pcloud_root: str,
    out_root: str,
    scenes: Optional[List[str]] = None,
    seq_name: str = "seq-01",
    raw_buckets=RAW_BUCKETS,
    num_devices: int = 1,
    sharded_n_pad: int = 32768,
    mesh=None,
) -> Dict:
    """Walk test scenes; per fragment: PLY + image → extract → save
    `.npz{points, xyz, feature}` (`scripts/generate_desc.py:83-123`) on the
    device of ``model``'s parameters. Raw points pad to the smallest raw
    bucket that holds the whole fragment (the reference quantizes every raw
    point, `util/misc.py:82-87`), voxels to the smallest voxel bucket
    (``make_bucketed_extractor``). PLY and image reads and the compressed
    writes run on threads beside the device loop, as in the JAX package.

    Returns the 'All Time' / 'AVG' stats (seconds of extraction, as
    `generate_desc.py:190` reports them).

    ``num_devices`` > 1 (0: every rank of ``mesh``) shards the fragments
    over the ranks of ``mesh``, which must have that many
    (``_generate_descriptors_sharded``)."""
    D = num_devices if num_devices else (mesh.world_size if mesh is not None else 1)
    if D > 1 and (mesh is None or mesh.world_size != D):
        raise ValueError(f"generate_descriptors: num_devices={D} runs on as many ranks; "
                         f"this process is {'no rank' if mesh is None else mesh}")
    scenes = scenes or TEST_SCENE_NAMES

    work = []
    for scene in scenes:
        scene_dir = osp.join(pcloud_root, scene, seq_name)
        out_dir = osp.join(out_root, scene, seq_name)
        os.makedirs(out_dir, exist_ok=True)
        for frag in list_fragments(scene_dir):
            out_path = osp.join(out_dir, frag + ".npz")
            if not osp.exists(out_path):
                work.append((scene_dir, frag, out_path))

    def load_one(item):
        scene_dir, frag, out_path = item
        points = read_ply(osp.join(scene_dir, frag + ".ply"))["points"].astype(np.float32)
        image = None
        for suffix in ("_0.png", "_0.jpg"):
            p = osp.join(scene_dir, frag + suffix)
            if osp.exists(p):
                image = process_image(load_image(p), config.image_H, config.image_W)
                break
        if image is None:
            image = np.zeros((config.image_H, config.image_W, 3), np.float32)
        raw, n_raw = pad_points_bucketed(points, raw_buckets)
        return points, raw, n_raw, image, out_path

    def save_one(out_path, points, xyz_down, feats):
        np.savez_compressed(out_path, points=points, xyz=xyz_down, feature=feats)

    if D > 1:
        return _generate_descriptors_sharded(model, config, work, load_one, save_one, mesh,
                                             n_pad=sharded_n_pad)
    extract = make_bucketed_extractor(model, config=config)
    total_t, count = 0.0, 0
    lookahead = 4  # bounded: each prefetched fragment holds ~6 MB host RAM
    with ThreadPoolExecutor(max_workers=2) as readers, \
            ThreadPoolExecutor(max_workers=2) as writers:
        # the writer backlog is bounded too: a queued save pins the
        # fragment's raw points and descriptors in host RAM
        pending_saves = deque()
        queue = deque(readers.submit(load_one, it) for it in work[:lookahead])
        next_i = len(queue)
        while queue:
            fut = queue.popleft()
            if next_i < len(work):
                queue.append(readers.submit(load_one, work[next_i]))
                next_i += 1
            points, raw, n_raw, image, out_path = fut.result()
            t0 = time.perf_counter()
            xyz_down, feats = extract(raw, n_raw, image[None])
            total_t += time.perf_counter() - t0
            count += 1
            while len(pending_saves) >= lookahead:
                pending_saves.popleft().result()
            pending_saves.append(writers.submit(save_one, out_path, points, xyz_down, feats))
        while pending_saves:
            pending_saves.popleft().result()
    stats = {"all_time": total_t, "avg_time": total_t / max(count, 1), "count": count}
    logging.info("All Time: %.3f, AVG: %.4f (%d fragments)",
                 stats["all_time"], stats["avg_time"], stats["count"])
    return stats


def _generate_descriptors_sharded(model, config: Config, work, load_one, save_one, mesh,
                                  n_pad: int = 32768) -> Dict:
    """Rank ``r`` of W loads fragments r, r + W, ... of ``work``, extracts
    them at one voxel pad ``n_pad`` (``parallel.dp.make_sharded_extractor``)
    and writes their ``.npz`` files. A fragment with ``n_pad`` voxels or
    more, or whose coarse levels do not fit, is extracted again through the
    bucketed extractor, with a warning: never truncated. Every rank has
    listed the work before any writes (a barrier). The stats are gathered:
    ``all_time`` is the slowest rank's extraction seconds, ``count`` the
    fragments of all ranks."""
    import torch.distributed as dist

    from imfnet_tpu_torch.parallel.dp import make_sharded_extractor, own_items
    from imfnet_tpu_torch.parallel.mesh import all_gather

    dist.barrier(group=mesh.group)
    mine = list(own_items(mesh, len(work)))
    extract = make_sharded_extractor(model, config, mesh, n_pad=n_pad)
    fallback = None
    total_t, count = 0.0, 0
    with ThreadPoolExecutor(max_workers=2) as readers, \
            ThreadPoolExecutor(max_workers=2) as writers:
        pending_saves = deque()
        queue = deque((i, readers.submit(load_one, work[i])) for i in mine[:4])
        next_i = len(queue)
        while queue:
            i, fut = queue.popleft()
            if next_i < len(mine):
                queue.append((mine[next_i], readers.submit(load_one, work[mine[next_i]])))
                next_i += 1
            points, raw, n_raw, image, out_path = fut.result()
            t0 = time.perf_counter()
            xyz_down, feats, nvalid, fits = extract([(i, (raw, n_raw, image[None]))])[i]
            nv, fits = int(nvalid), bool(fits)
            if nv >= n_pad or not fits:
                logging.warning(
                    "fragment %s overflows the sharded capacity (%d voxels / n_pad %d, "
                    "coarse levels fit: %s); extracting it again through the bucketed "
                    "extractor", out_path, nv, n_pad, fits)
                if fallback is None:
                    fallback = make_bucketed_extractor(model, config=config)
                xd, fd = fallback(raw, n_raw, image[None])
            else:
                xd, fd = xyz_down[:nv].numpy(), feats[:nv].float().numpy()
            total_t += time.perf_counter() - t0
            count += 1
            while len(pending_saves) >= 4:
                pending_saves.popleft().result()
            pending_saves.append(writers.submit(save_one, out_path, points, xd, fd))
        while pending_saves:
            pending_saves.popleft().result()
    per_rank = all_gather(mesh, (total_t, count))
    all_time = max(t for t, _ in per_rank)
    count = sum(c for _, c in per_rank)
    stats = {"all_time": all_time, "avg_time": all_time / max(count, 1), "count": count,
             "num_devices": mesh.world_size}
    logging.info("All Time: %.3f, AVG: %.4f (%d fragments, %d ranks, %s)", stats["all_time"],
                 stats["avg_time"], count, mesh.world_size, mesh.backend)
    return stats


def sample_or_load_keypoints(
    keypoints_root: str,
    scene_name: str,
    seq_name: str,
    frag1_id: int,
    frag2_id: int,
    n_i: int,
    n_j: int,
    num_rand_keypoints: int,
    use_saved: bool,
    rng: np.random.RandomState,
):
    """Per-pair raw-point keypoint indices, persisted for replay
    (`scripts/evaluation_3dmatch.py:140-160`): min(N, num_rand_keypoints)
    random raw point indices per fragment, cached as
    `{scene}_{seq}_{i}_{j}_keypoints.npz{inds_i, inds_j}` under
    ``keypoints_root``; ``use_saved`` replays an existing cache."""
    os.makedirs(keypoints_root, exist_ok=True)
    path = osp.join(keypoints_root,
                    f"{scene_name}_{seq_name}_{frag1_id}_{frag2_id}_keypoints.npz")
    if use_saved:
        kp = np.load(path)
        return kp["inds_i"], kp["inds_j"]
    inds_i = rng.choice(n_i, min(n_i, num_rand_keypoints), replace=False)
    inds_j = rng.choice(n_j, min(n_j, num_rand_keypoints), replace=False)
    np.savez(path, inds_i=inds_i, inds_j=inds_j)
    return inds_i, inds_j


def make_scene_register(config: Config, inlier_thresh: float, device=None):
    """register(k, kp0, kd0, ok0, kp1, kd1, ok1, T_gt, cov, *, swap) on the
    device: ``register_kp`` with the RANSAC draws of pair ``k`` from a
    generator on the device seeded with ``k``."""
    dev = resolve_device(device)
    register_kp = make_keypoint_registration(
        voxel_size=config.voxel_size, ransac_n=config.ransac_n,
        num_hypotheses=config.ransac_max_iteration, inlier_thresh=inlier_thresh)

    def register(k, kp0, kd0, ok0, kp1, kd1, ok1, T_gt, covariance, *, swap: bool):
        gen = torch.Generator(device=dev).manual_seed(k)
        return register_kp(kp0, kd0, ok0, kp1, kd1, ok1, T_gt, covariance,
                           generator=gen, swap=swap)

    return register


def run_scene_matching(
    scene_name: str,
    seq_name: str,
    desc_type: str,
    desc_root: str,
    out_root: str,
    benchmark_dir: str,
    config: Config,
    inlier_thresh: float = 0.1,
    register=None,
    kpt_pad: Optional[int] = None,
    keypoints_root: Optional[str] = None,
    use_saved_keypoints: Optional[bool] = None,
    device=None,
) -> Dict:
    """Per gt.log pair registration and stats
    (`scripts/evaluation_3dmatch.py:239-336`).

    The reference's keypoint protocol: 5000 random raw points per fragment
    (cached npz, replayable), mapped to descriptor rows by fnv-hashed
    voxel-key intersection (`evaluation_3dmatch.py:140-174`). RANSAC runs
    with the smaller keypoint set as source (`:182-186`). The keypoints go
    to ``device`` (default the card) and to ``register`` (default
    ``make_scene_register``), which is called with the pair index ``k``
    first."""
    out_folder = osp.join(out_root, desc_type)
    os.makedirs(out_folder, exist_ok=True)
    out_filename = "{}-{}-{:.2f}".format(scene_name, seq_name, inlier_thresh)
    result_path = osp.join(out_folder, out_filename + ".json")
    if osp.isfile(result_path):
        logging.info("%s exists, skipping", out_filename)
        with open(result_path) as f:
            return json.load(f)

    poses = read_log(osp.join(benchmark_dir, scene_name, "gt.log"))
    infos = read_info_file(osp.join(benchmark_dir, scene_name, "gt.info"))
    dev = resolve_device(device)
    if register is None:
        register = make_scene_register(config, inlier_thresh, dev)
    # ≤ num_rand_keypoints sampled raw points → ≤ that many distinct voxels
    kpt_pad = kpt_pad or config.num_rand_keypoints
    if keypoints_root is None:
        keypoints_root = osp.join(out_root, desc_type + "_keypoints")
    if use_saved_keypoints is None:
        use_saved_keypoints = config.use_saved_keypoints
    kp_rng = np.random.RandomState(config.seed)

    scene_dir = osp.join(desc_root, scene_name, seq_name)
    frag_names = sorted({f[:-4] for f in os.listdir(scene_dir) if f.endswith(".npz")},
                        key=lambda n: int(n.split("_")[-1]))

    def load_frag(name):
        d = np.load(osp.join(scene_dir, name + ".npz"))
        return d["points"], d["xyz"], d["feature"]

    def pad_rows(xyz, feat, rows):
        rows = rows[:kpt_pad]
        xp = np.zeros((kpt_pad, 3), np.float32)
        fp = np.zeros((kpt_pad, feat.shape[1]), np.float32)
        xp[: len(rows)] = xyz[rows]
        fp[: len(rows)] = feat[rows]
        ok = np.arange(kpt_pad) < len(rows)
        return (torch.from_numpy(xp).to(dev), torch.from_numpy(fp).to(dev),
                torch.from_numpy(ok).to(dev), len(rows))

    results = []
    for k, pose in enumerate(poses):
        i, j, _ = pose.indices
        pts0, x0, f0 = load_frag(frag_names[i])
        pts1, x1, f1 = load_frag(frag_names[j])
        inds_i, inds_j = sample_or_load_keypoints(
            keypoints_root, scene_name, seq_name, i, j, len(pts0), len(pts1),
            config.num_rand_keypoints, use_saved_keypoints, kp_rng)
        rows0 = voxel_key_rows(pts0[inds_i], x0, config.voxel_size)
        rows1 = voxel_key_rows(pts1[inds_j], x1, config.voxel_size)
        kp0, kd0, ok0, nk0 = pad_rows(x0, f0, rows0)
        kp1, kd1, ok1, nk1 = pad_rows(x1, f1, rows1)
        out = register(
            k, kp0, kd0, ok0, kp1, kd1, ok1,
            torch.from_numpy(pose.transformation.astype(np.float32)).to(dev),
            torch.from_numpy(np.asarray(infos[k]["covariance"], np.float32)).to(dev),
            swap=bool(nk0 >= nk1))  # smaller side as RANSAC source (:182-186)
        results.append({
            "frag1": frag_names[i],
            "frag2": frag_names[j],
            "num_inliers": float(out["num_inliers"]),
            "inlier_ratio": float(out["inlier_ratio_mutual"]),
            "gt_flag": 1,
            "rr": float(out["rr"]),
            "rre": float(out["rre"]),
            "rte": float(out["rte"]),
            "rre_raw": float(out["rre_raw"]),
            "rte_raw": float(out["rte_raw"]),
            "ir": float(out["ir"]),
            # estimated and ground-truth poses, for cross-method export
            "transformation": out["transformation"].cpu().numpy().tolist(),
            "T_gt": pose.transformation.tolist(),
        })

    payload = {
        "register_results": results,
        "scene_name": scene_name,
        "seq_name": seq_name,
        "desc_type": desc_type,
        "inlier_thresh": inlier_thresh,
        "num_pairs": len(poses),
    }
    with open(result_path, "w") as f:
        json.dump(payload, f)
    with open(osp.join(out_folder, out_filename + ".txt"), "w") as f:
        for r in results:
            f.write("{frag1} {frag2} {num_inliers} {inlier_ratio:.8f} "
                    "{gt_flag} {rr} {rre} {rte} {ir}\n".format(**r))
    return payload


def compute_metrics(
    scene_payloads: List[Dict],
    config: Config,
    out_root: str,
    desc_type: str = "IMFNet",
    inlier_thresh: float = 0.1,
) -> Dict:
    """Aggregate FMR (mean/std over scenes at τ2 thresholds), RR, RRE, RTE, IR
    (`scripts/evaluation_3dmatch.py:338-498`). Writes CSV, prints summary."""
    threshes = list(config.fmr_inlier_ratio_threshes)
    all_recalls, all_inliers = [], []
    total_rr, total_rre, total_rte, total_pairs = 0.0, 0.0, 0.0, 0
    all_ir, scenes = [], []
    for payload in scene_payloads:
        rs = payload["register_results"]
        scenes.append(payload["scene_name"])
        ir = np.array([r["inlier_ratio"] for r in rs])
        all_recalls.append([float((ir > t).mean()) for t in threshes])
        all_inliers.append(float(np.mean([r["num_inliers"] for r in rs])))
        total_rr += sum(r["rr"] for r in rs)
        total_rre += sum(r["rre"] for r in rs)
        total_rte += sum(r["rte"] for r in rs)
        total_pairs += payload["num_pairs"]
        all_ir.append(float(np.mean([r["ir"] for r in rs])))

    avg_recalls = np.mean(np.asarray(all_recalls), axis=0)
    std_recalls = np.std(np.asarray(all_recalls), axis=0)
    rr = total_rr / max(total_pairs, 1)
    rre = total_rre / max(total_rr, 1)
    rte = total_rte / max(total_rr, 1)
    ir = float(np.mean(all_ir))

    out_path = osp.join(out_root, f"{desc_type}-metrics-{inlier_thresh:.2f}.csv")
    os.makedirs(out_root, exist_ok=True)
    with open(out_path, "w") as f:
        header = "SceneName" + "".join(
            f",Recall-{t:.2f},AverageMatches-{t:.2f}" for t in threshes)
        f.write(header + "\n")
        for s, recalls, inl in zip(scenes, all_recalls, all_inliers):
            f.write(s + "".join(f",{r:.6f},{inl:.3f}" for r in recalls) + "\n")
        f.write("Average" + "".join(
            f",{r:.6f},{i:.3f}" for r, i in
            zip(avg_recalls, [np.mean(all_inliers)] * len(threshes))) + "\n")

    summary = {
        "FMR": avg_recalls.tolist(),
        "FMR_std": std_recalls.tolist(),
        "registration_recall": rr,
        "RRE": rre,
        "RTE": rte,
        "inlier_ratio": ir,
        "threshes": threshes,
        "num_pairs": total_pairs,
    }
    print(f"------- {desc_type} ---------")
    print(f"FMR:{avg_recalls}")
    print(f"STD:{std_recalls}")
    print(f"Registration Recall:{rr}")
    print(f"RRE:{rre}")
    print(f"RTE:{rte}")
    print(f"Inlier Ratio:{ir}")
    print(f"------- {desc_type} ---------")
    with open(osp.join(out_root, f"{desc_type}-summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def plot_recall_curve(
    scene_payloads: List[Dict],
    out_root: str,
    desc_type: str = "IMFNet",
    threshes: Optional[List[float]] = None,
) -> str:
    """FMR against the inlier-ratio threshold (`scripts/evaluation_3dmatch.py:
    450-498`): always a CSV of the curve, and a PDF where matplotlib
    imports. Returns the PDF's path, else the CSV's."""
    threshes = threshes or [round(0.01 * i, 2) for i in range(1, 21)]
    irs = np.array([r["inlier_ratio"] for p in scene_payloads
                    for r in p["register_results"]])
    recalls = [float((irs > t).mean()) for t in threshes]
    os.makedirs(out_root, exist_ok=True)
    csv_path = osp.join(out_root, f"{desc_type}-recall-curve.csv")
    with open(csv_path, "w") as f:
        f.write("tau2,recall\n")
        for t, r in zip(threshes, recalls):
            f.write(f"{t},{r:.6f}\n")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logging.info("matplotlib unavailable; recall curve saved as CSV only")
        return csv_path
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(threshes, recalls, marker="o", lw=1.5, label=desc_type)
    ax.set_xlabel("inlier ratio threshold τ2")
    ax.set_ylabel("feature match recall")
    ax.set_ylim(0, 1.02)
    ax.grid(alpha=0.3)
    ax.legend()
    pdf_path = osp.join(out_root, f"{desc_type}-recall-curve.pdf")
    fig.savefig(pdf_path, bbox_inches="tight")
    plt.close(fig)
    return pdf_path


def resolve_benchmark_dir(benchmark_dir: str, benchmark: Optional[str]) -> str:
    """The fixture set for ``benchmark`` (3DMatch | 3DLoMatch): either a
    fixtures root with that subdirectory, or a directory of that name
    (`scripts/evaluation_3dmatch.py:272-273,582`); anything else raises
    rather than mislabelling results."""
    if benchmark is None:
        return benchmark_dir
    sub = osp.join(benchmark_dir, benchmark)
    if osp.isdir(sub):
        return sub
    if osp.basename(osp.normpath(benchmark_dir)).lower() == benchmark.lower():
        return benchmark_dir
    raise ValueError(
        f"--benchmark {benchmark}: {benchmark_dir!r} has no {benchmark}/ "
        f"subdirectory and is not itself named {benchmark}; refusing to "
        f"label its results as {benchmark}")


def evaluate(
    config: Config,
    desc_root: str,
    out_root: str,
    benchmark_dir: str,
    desc_type: str = "IMFNet",
    scenes: Optional[List[str]] = None,
    seq_name: str = "seq-01",
    keypoints_root: Optional[str] = None,
    use_saved_keypoints: Optional[bool] = None,
    benchmark: Optional[str] = None,
    device=None,
    register=None,
) -> Dict:
    """Full benchmark loop (`scripts/evaluation_3dmatch.py:501-553`) on
    ``device`` (default the card). ``register`` replaces
    ``make_scene_register``'s."""
    benchmark_dir = resolve_benchmark_dir(benchmark_dir, benchmark)
    scenes = scenes or TEST_SCENE_NAMES
    dev = resolve_device(device)
    if register is None:
        register = make_scene_register(config, config.inlier_thresh, dev)
    payloads = [
        run_scene_matching(
            s, seq_name, desc_type, desc_root, out_root, benchmark_dir,
            config, config.inlier_thresh, register=register,
            keypoints_root=keypoints_root,
            use_saved_keypoints=use_saved_keypoints, device=dev)
        for s in scenes
    ]
    plot_recall_curve(payloads, out_root, desc_type)
    summary = compute_metrics(payloads, config, out_root, desc_type,
                              config.inlier_thresh)
    summary["benchmark"] = benchmark or osp.basename(osp.normpath(benchmark_dir))
    return summary
