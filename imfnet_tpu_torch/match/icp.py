"""Point-to-point ICP as a fixed-iteration loop (``imfnet_tpu.match.icp``).

Replaces `o3d.pipelines.registration.registration_icp` used to refine KITTI
ground-truth poses (`lib/data_loaders.py:540-543`, threshold 0.2,
TransformationEstimationPointToPoint). Correspondences come from
``nn_auto`` (kernel B at D = 3 for CUDA tensors, one launch an iteration);
each iteration refits with Horn/Kabsch over the pairs within
``max_correspondence_distance``, on the original source, so T is absolute.

As the JAX package jits it (``imfnet_tpu/match/icp.py:20``, static
``iters``), the loop is one CUDA graph per signature on the card (the
clouds' sizes, ``iters`` and the distance; ``utils.graphs.jit``), and eager
on the CPU. It reads nothing back and draws nothing. The graph may be
captured and replayed from a loader's producer thread beside the main
thread's graphs (thread-local capture, a lock).
"""
from __future__ import annotations

import torch

from imfnet_tpu_torch.match.metrics import apply_transform
from imfnet_tpu_torch.match.nn import nn_auto
from imfnet_tpu_torch.match.procrustes import kabsch_umeyama
from imfnet_tpu_torch.utils.graphs import jit


def icp_loop(src, dst, src_valid, dst_valid, T, max_correspondence_distance: float,
             iters: int) -> torch.Tensor:
    """The ``iters`` iterations from ``T`` (f32 [4,4] on the clouds'
    device): the graph's body, and the CPU's path."""
    for _ in range(iters):
        idx, d2 = nn_auto(apply_transform(src, T), dst, dst_valid)
        ok = src_valid & (d2 <= max_correspondence_distance ** 2)
        T = kabsch_umeyama(src, dst[idx.long()], weights=ok.float())
    return T


# one graph per signature, for the process; a replay returns a clone of T
icp_graphed = jit(icp_loop, clone=True)


def icp_point_to_point(
    src: torch.Tensor,        # [N,3]
    dst: torch.Tensor,        # [M,3]
    src_valid: torch.Tensor,  # bool[N]
    dst_valid: torch.Tensor,  # bool[M]
    init_T: torch.Tensor,     # [4,4]
    max_correspondence_distance: float,
    *,
    iters: int = 30,
    graphed: bool = True,
) -> torch.Tensor:
    """T [4,4] f32 with T src ≈ dst after ``iters`` iterations; no host
    read. On the card a replay of ``icp_graphed`` (``graphed=False``: the
    eager loop)."""
    src = src.float().contiguous()
    dst = dst.float().contiguous()
    T = init_T.to(device=src.device, dtype=torch.float32)
    args = (src, dst, src_valid.to(src.device), dst_valid.to(src.device), T,
            float(max_correspondence_distance), int(iters))
    if graphed and src.device.type == "cuda":
        return icp_graphed(*args)
    return icp_loop(*args)
