"""Registration views as coloured PLY files (``imfnet_tpu.utils.visualization``).

The reference (`util/visualization.py:98-645`) opens Open3D windows showing
registration before and after and the correspondences; a headless machine
has no display, so every view is written as a coloured PLY instead.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from imfnet_tpu_torch.geom.ply import write_ply
from imfnet_tpu_torch.geom.transforms import apply_transform_np

# the reference's two-cloud colouring (yellow/blue, `util/visualization.py`)
COLOR_SRC = np.array([1.0, 0.706, 0.0])
COLOR_DST = np.array([0.0, 0.651, 0.929])


def save_registration_view(path: str, xyz0: np.ndarray, xyz1: np.ndarray,
                           transform: Optional[np.ndarray] = None) -> None:
    """Both clouds in one PLY; xyz0 transformed when a pose is given (the
    before/after views of `visualization_ours`, `util/visualization.py:98-194`)."""
    p0 = apply_transform_np(xyz0, transform) if transform is not None else xyz0
    pts = np.concatenate([p0, xyz1]).astype(np.float32)
    cols = np.concatenate([np.tile(COLOR_SRC, (len(p0), 1)),
                           np.tile(COLOR_DST, (len(xyz1), 1))])
    write_ply(path, pts, colors=cols)


def visualize_pair_registration(model: torch.nn.Module, config, ply0: str, image0: str,
                                ply1: str, image1: str, out_dir: str,
                                num_keypoints: int = 5000,
                                register: Optional[Callable] = None):
    """The `visualization_ours` pipeline (`util/visualization.py:98-194`):
    descriptors of both fragments through the bucketed extractor, feature
    RANSAC, and ``before.ply`` / ``after.ply`` in ``out_dir``. Runs on the
    model's device. Returns (T01 [4,4], the transform that maps cloud 0 onto
    cloud 1, and the RANSAC fitness).

    The draws come from a generator on the device seeded with 0 (the JAX
    package passes ``PRNGKey(0)``); ``register(xyz0, f0, n0, xyz1, f1, n1,
    T_gt, cov)``, a ``make_pair_registration`` register with its draws
    bound, replaces them."""
    from imfnet_tpu_torch.eval.extract import make_bucketed_extractor, pad_points_bucketed
    from imfnet_tpu_torch.eval.registration import make_pair_registration
    from imfnet_tpu_torch.geom.image import load_image, process_image
    from imfnet_tpu_torch.geom.ply import read_ply

    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device
    extract = make_bucketed_extractor(model, config=config)
    sides = []
    for ply, img in ((ply0, image0), (ply1, image1)):
        pts = read_ply(ply)["points"].astype(np.float32)
        if img:
            im = process_image(load_image(img), config.image_H, config.image_W)
        else:
            im = np.zeros((config.image_H, config.image_W, 3), np.float32)
        raw, n_raw = pad_points_bucketed(pts)
        xyz_down, feats = extract(raw, n_raw, im[None])
        sides.append((pts, xyz_down, feats))

    n_pad = 1 << int(np.ceil(np.log2(max(len(sides[0][1]), len(sides[1][1])))))

    def padded(x):
        out = np.zeros((n_pad, x.shape[1]), np.float32)
        out[:len(x)] = x
        return torch.from_numpy(out).to(dev)

    if register is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        reg = make_pair_registration(
            num_keypoints=num_keypoints, voxel_size=config.voxel_size,
            ransac_n=config.ransac_n, num_hypotheses=config.ransac_max_iteration,
            inlier_thresh=config.inlier_thresh)

        def register(*args):
            return reg(*args, generator=gen)

    out = register(padded(sides[0][1]), padded(sides[0][2]), len(sides[0][1]),
                   padded(sides[1][1]), padded(sides[1][2]), len(sides[1][1]),
                   torch.eye(4, device=dev), torch.eye(6, device=dev))
    # the registration gives the gt.log-convention pose (1 → 0); invert it
    T01 = np.linalg.inv(out["transformation"].cpu().numpy())
    save_registration_view(os.path.join(out_dir, "before.ply"), sides[0][0], sides[1][0])
    save_registration_view(os.path.join(out_dir, "after.ply"), sides[0][0], sides[1][0],
                           transform=T01)
    return T01, float(out["fitness"])


def save_correspondence_view(path: str, xyz0: np.ndarray, xyz1: np.ndarray,
                             pairs: np.ndarray, correct: Optional[np.ndarray] = None,
                             line_points: int = 8) -> None:
    """Correspondence 'lines' between matched rows ``pairs[K, 2]`` drawn as
    ``line_points`` samples each: green where ``correct``, red elsewhere."""
    if correct is None:
        correct = np.ones(len(pairs), bool)
    t = np.linspace(0.0, 1.0, line_points)[None, :, None]
    a = xyz0[pairs[:, 0]][:, None, :]
    b = xyz1[pairs[:, 1]][:, None, :]
    segs = (a * (1 - t) + b * t).reshape(-1, 3)
    col = np.where(np.repeat(correct, line_points)[:, None],
                   np.array([[0.0, 1.0, 0.0]]), np.array([[1.0, 0.0, 0.0]]))
    pts = np.concatenate([xyz0, xyz1, segs]).astype(np.float32)
    cols = np.concatenate([np.tile(COLOR_SRC, (len(xyz0), 1)),
                           np.tile(COLOR_DST, (len(xyz1), 1)), col])
    write_ply(path, pts, colors=cols)
