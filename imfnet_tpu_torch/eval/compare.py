"""Cross-method benchmark comparison and external descriptor conversion
(``imfnet_tpu.eval.compare``), the reference's comparison tooling:
- `spinnet_desc` (`util/visualization.py:196-231`): reformat an external
  method's per-fragment descriptor/keypoint files into the `.npz{xyz,
  feature}` contract this framework's evaluator consumes.
- `visualization_3DMatch` / `visualization_Kitti`
  (`util/visualization.py:233-645`): register every gt pair with several
  methods' descriptors, tabulate per-pair success side by side, select the
  pairs where the primary method succeeds and every baseline fails, and
  export registered before/after views for them (colored PLYs instead of
  Open3D windows: a headless machine has no display).
"""
from __future__ import annotations

import csv
import glob
import logging
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from imfnet_tpu_torch.config import Config


def convert_external_descriptors(
    desc_root: str,
    keypoint_root: str,
    out_root: str,
    *,
    desc_glob: str = "*.npy",
    keypoint_replace: tuple = (".desc.SpinNet.bin", "_keypts"),
    seq_name: str = "seq-01",
) -> List[str]:
    """Walk `desc_root/<scene>/<frag>.npy` + matching keypoint .npy files and
    write `out_root/<scene>/seq-01/<frag_id>.npz{xyz, feature}` — the
    `spinnet_desc` reformat (`util/visualization.py:196-231`), generalized
    via ``keypoint_replace`` for other methods' naming schemes."""
    written = []
    for scene_dir in sorted(glob.glob(osp.join(desc_root, "*"))):
        if not osp.isdir(scene_dir):
            continue
        scene = osp.basename(scene_dir)
        out_dir = osp.join(out_root, scene, seq_name)
        os.makedirs(out_dir, exist_ok=True)
        for desc_path in sorted(glob.glob(osp.join(scene_dir, desc_glob))):
            name = osp.basename(desc_path)
            frag_id = name.split(".")[0]
            kp_name = name[: -len(".npy")].replace(*keypoint_replace) + ".npy"
            kp_path = osp.join(keypoint_root, scene, kp_name)
            if not osp.exists(kp_path):
                logging.warning("no keypoints for %s (looked at %s)", name, kp_path)
                continue
            xyz = np.load(kp_path)
            feature = np.load(desc_path)
            out_path = osp.join(out_dir, frag_id + ".npz")
            np.savez(out_path, xyz=xyz, feature=feature)
            written.append(out_path)
    return written


def compare_methods(
    desc_roots: Dict[str, str],   # method name → descriptor root (.npz layout)
    benchmark_dir: str,
    out_root: str,
    config: Config,
    scenes: Optional[List[str]] = None,
    *,
    seq_name: str = "seq-01",
    save_views: bool = True,
    max_views: int = 20,
    keypoints_root: Optional[str] = None,
    device=None,
    register=None,
) -> Dict:
    """Register every gt pair with each method's descriptors and tabulate
    them side by side. The FIRST entry of ``desc_roots`` is the primary
    method; pairs it registers (rr=1) that every baseline misses are the
    "select" set (the pairs `visualization_3DMatch` renders,
    `util/visualization.py:233-409`), exported as registered before/after
    PLY views from the primary method's estimated pose.

    Registration runs on ``device`` (default the card) through
    ``register`` (default ``threedmatch.make_scene_register``).

    Returns {"per_method": {name: {"rr": float}}, "select":
    [(scene, frag1, frag2), ...], "csv": path}.
    """
    from imfnet_tpu_torch.eval.threedmatch import (TEST_SCENE_NAMES, make_scene_register,
                                                  run_scene_matching)
    from imfnet_tpu_torch.geom.transforms import apply_transform_np
    from imfnet_tpu_torch.utils.device import resolve_device
    from imfnet_tpu_torch.utils.visualization import save_registration_view

    if scenes is None:
        scenes = [s for s in TEST_SCENE_NAMES
                  if osp.isdir(osp.join(benchmark_dir, s))]
    methods = list(desc_roots)
    # all methods replay ONE keypoint set (sampled+persisted by the first
    # method, or externally provided via ``keypoints_root``) so the
    # comparison is apples-to-apples — the reference's cached-keypoints
    # replay (`evaluation_3dmatch.py:140-160`)
    if keypoints_root is None:
        keypoints_root = osp.join(out_root, "shared_keypoints")
        kp_preexisting = osp.isdir(keypoints_root) and os.listdir(keypoints_root)
    else:
        kp_preexisting = True
    device = resolve_device(device)
    if register is None:   # run_scene_matching's default inlier_thresh
        register = make_scene_register(config, 0.1, device)
    payloads: Dict[str, List[Dict]] = {m: [] for m in methods}
    for mi, m in enumerate(methods):
        for scene in scenes:
            payloads[m].append(run_scene_matching(
                scene, seq_name, m, desc_roots[m],
                osp.join(out_root, "per_method"), benchmark_dir, config,
                register=register, device=device,
                keypoints_root=keypoints_root,
                use_saved_keypoints=bool(kp_preexisting or mi > 0)))

    # side-by-side table + select set. Select semantics follow the
    # reference's comparison exporter (`util/visualization.py:363-409`):
    # success := rte < 0.3 m ∧ rre < 15°, the select set is "primary
    # succeeds, every baseline fails", and each pair gets a txt record of
    # every method's errors + estimated transform + GT.
    rte_thresh, rre_thresh_deg = 0.3, 15.0

    def _succeeds(r):
        rre = r.get("rre_raw", r["rre"])
        rte = r.get("rte_raw", r["rte"])
        return rte < rte_thresh and np.isfinite(rre) and rre < rre_thresh_deg

    os.makedirs(out_root, exist_ok=True)
    csv_path = osp.join(out_root, "comparison.csv")
    result_dir = osp.join(out_root, "result")       # primary successes
    select_dir = osp.join(out_root, "result_select")  # exclusive successes
    os.makedirs(result_dir, exist_ok=True)
    os.makedirs(select_dir, exist_ok=True)
    select: List[tuple] = []
    totals = {m: [0, 0] for m in methods}

    def _write_record(path, scene, rows, all_methods):
        with open(path, "w") as f:
            items = zip(methods, rows) if all_methods else [(methods[0], rows[0])]
            for m, r in items:
                f.write(f"{m}---rte:{r.get('rte_raw', r['rte'])},"
                        f"rre:{r.get('rre_raw', r['rre'])},T:\n")
                f.write("\n".join(" ".join(f"{v:.8f}" for v in row)
                                  for row in r["transformation"]) + "\n")
            f.write("Ground Truth,T:\n")
            f.write("\n".join(" ".join(f"{v:.8f}" for v in row)
                              for row in np.asarray(rows[0]["T_gt"])) + "\n")

    with open(csv_path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["scene", "frag1", "frag2"]
                    + [f"{m}_{k}" for m in methods for k in ("rr", "rre", "rte")])
        for si, scene in enumerate(scenes):
            by_method = [payloads[m][si]["register_results"] for m in methods]
            for pi in range(len(by_method[0])):
                rows = [bm[pi] for bm in by_method]
                wr.writerow(
                    [scene, rows[0]["frag1"], rows[0]["frag2"]]
                    + [round(r[k], 4) for r in rows for k in ("rr", "rre", "rte")])
                for m, r in zip(methods, rows):
                    totals[m][0] += r["rr"]
                    totals[m][1] += 1
                pair_name = f"{scene}_{rows[0]['frag1']}-{rows[0]['frag2']}.txt"
                if _succeeds(rows[0]):
                    _write_record(osp.join(result_dir, pair_name), scene,
                                  rows, all_methods=False)
                # exclusive success — meaningless with no baseline (the
                # all() is vacuously true for one method)
                if len(methods) > 1 and _succeeds(rows[0]) \
                        and all(not _succeeds(r) for r in rows[1:]):
                    _write_record(osp.join(select_dir, pair_name), scene,
                                  rows, all_methods=True)
                    select.append((scene, rows[0]["frag1"], rows[0]["frag2"],
                                   rows[0].get("transformation")))

    views = []
    if save_views:
        view_dir = osp.join(out_root, "select_views")
        os.makedirs(view_dir, exist_ok=True)
        primary = methods[0]
        for scene, f1, f2, T in select[:max_views]:
            d1 = np.load(osp.join(desc_roots[primary], scene, seq_name, f1 + ".npz"))
            d2 = np.load(osp.join(desc_roots[primary], scene, seq_name, f2 + ".npz"))
            base = f"{scene}-{f1}-{f2}"
            save_registration_view(
                osp.join(view_dir, base + "-before.ply"), d1["xyz"], d2["xyz"])
            if T is not None:
                # run_scene_matching stores the gt.log-convention pose
                # (maps frag2 → frag1): transform side 2 into side 1's frame
                pts2 = apply_transform_np(d2["xyz"], np.asarray(T))
                save_registration_view(
                    osp.join(view_dir, base + "-after.ply"), d1["xyz"], pts2,
                    transform=None)
            views.append(base)

    summary = {
        "per_method": {m: {"rr": totals[m][0] / max(totals[m][1], 1)}
                       for m in methods},
        "select": [(s, a, b) for s, a, b, _ in select],
        "csv": csv_path,
        "result_dir": result_dir,
        "select_dir": select_dir,
        "views": views,
    }
    logging.info("comparison: %s; %d select pairs",
                 {m: round(v["rr"], 4) for m, v in summary["per_method"].items()},
                 len(select))
    return summary
