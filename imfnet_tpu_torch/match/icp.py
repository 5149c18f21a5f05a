"""Point-to-point ICP as a fixed-iteration loop (``imfnet_tpu.match.icp``).

Replaces `o3d.pipelines.registration.registration_icp` used to refine KITTI
ground-truth poses (`lib/data_loaders.py:540-543`, threshold 0.2,
TransformationEstimationPointToPoint). Correspondences come from
``nn_auto`` (kernel B at D = 3 for CUDA tensors, one launch an iteration);
each iteration refits with Horn/Kabsch over the pairs within
``max_correspondence_distance``, on the original source, so T is absolute.
"""
from __future__ import annotations

import torch

from imfnet_tpu_torch.match.metrics import apply_transform
from imfnet_tpu_torch.match.nn import nn_auto
from imfnet_tpu_torch.match.procrustes import kabsch_umeyama


def icp_point_to_point(
    src: torch.Tensor,        # [N,3]
    dst: torch.Tensor,        # [M,3]
    src_valid: torch.Tensor,  # bool[N]
    dst_valid: torch.Tensor,  # bool[M]
    init_T: torch.Tensor,     # [4,4]
    max_correspondence_distance: float,
    *,
    iters: int = 30,
) -> torch.Tensor:
    """T [4,4] f32 with T src ≈ dst after ``iters`` iterations; no host read."""
    src = src.float().contiguous()
    dst = dst.float().contiguous()
    T = init_T.to(device=src.device, dtype=torch.float32)
    for _ in range(iters):
        idx, d2 = nn_auto(apply_transform(src, T), dst, dst_valid)
        ok = src_valid & (d2 <= max_correspondence_distance ** 2)
        T = kabsch_umeyama(src, dst[idx.long()], weights=ok.float())
    return T
