"""Pair registration and benchmark metrics (`register_fragment_pair`,
`scripts/evaluation_3dmatch.py:89-236`): keypoint sampling, descriptor NN in
both directions, RANSAC, the covariance RR test, RRE/RTE, and the mutual-NN
inlier ratio for FMR.

Inside a CUDA graph the stages are ``registration.keypoints`` (the pair
registration's sampling), ``registration.nn`` (both NN directions) and
``registration.ransac`` (RANSAC and the metrics): ``utils.timer.stage``.
"""
from __future__ import annotations

from typing import Optional

import torch

from imfnet_tpu_torch.match.metrics import (apply_transform, inlier_ratio, inverse,
                                            registration_error, transform_error)
from imfnet_tpu_torch.match.nn import nn_auto, queries_valid
from imfnet_tpu_torch.match.ransac import ransac_registration, sample_shape
from imfnet_tpu_torch.utils import timer
from imfnet_tpu_torch.utils.graphs import jit


def _sample_rows(eligible: torch.Tensor, k: int,
                 generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None):
    """k rows uniformly without replacement from the eligible rows: uniform
    keys (from ``generator``, or injected as ``u[n]``), eligible rows keep
    theirs and the rest get 2.0, one sort, the first k. Returns (rows
    long[k], ok bool[k])."""
    n = eligible.shape[0]
    if u is None:
        u = torch.rand(n, generator=generator, device=eligible.device)
    keys = torch.where(eligible, u, torch.full_like(u, 2.0))
    rows = torch.sort(keys).indices
    n_el = eligible.long().sum()
    ok = torch.arange(k, device=eligible.device) < torch.clamp_max(n_el, k)
    return rows[:k], ok


def sample_keypoints_segment(start, count, k: int, n_rows: int, *,
                             device=None, generator=None, u=None):
    """k uniform-without-replacement rows of the segment [start,
    start + count) of a table with n_rows rows."""
    dev = device if u is None else u.device
    r = torch.arange(n_rows, device=dev)
    return _sample_rows((r >= start) & (r < start + count), k, generator, u)


def sample_keypoints(valid: torch.Tensor, k: int, *, generator=None, u=None):
    """k uniform random valid rows (`evaluation_3dmatch.py:154-156`)."""
    return _sample_rows(valid, k, generator, u)


def make_keypoint_registration(*, voxel_size: float = 0.025,
                               ransac_n: int = 3, num_hypotheses: int = 50000,
                               inlier_thresh: float = 0.1,
                               hypo_block: int = 12500,
                               distance_multiplier: float = 1.5):
    """register_kp(kp0, kd0, ok0, kp1, kd1, ok1, T_gt, cov, *, generator,
    samples, swap) on sampled keypoints. The RANSAC correspondence distance is
    ``voxel_size * distance_multiplier`` (1.5 for 3DMatch).
    ``register_kp.sample_shape`` is the shape of RANSAC's uniforms, which
    ``samples`` may give in place of the draws from ``generator``."""
    distance_threshold = voxel_size * distance_multiplier

    def register_kp(kp0, kd0, ok0, kp1, kd1, ok1, T_gt, covariance, *,
                    generator=None, samples=None, swap: bool = False):
        timer.stage("registration.nn")
        # each direction searches its valid keypoints alone (the others get
        # index 0, which everything below masks): kernel B walks only the
        # valid spans. The mask goes in by queries_valid, so that the call
        # keeps nn_auto's (queries, refs, ref_valid) form for a wrapper of it.
        with queries_valid(ok0):
            nn01 = nn_auto(kd0, kd1, ok1)[0].long()
        with queries_valid(ok1):
            nn10 = nn_auto(kd1, kd0, ok0)[0].long()
        timer.stage("registration.ransac")
        kw = dict(ransac_n=ransac_n, num_hypotheses=num_hypotheses,
                  hypo_block=hypo_block, generator=generator, samples=samples)
        if swap:
            res = ransac_registration(kp1, kp0[nn10], ok1, distance_threshold, **kw)
            es_T = res.transformation       # source=1 maps 1→0 directly
        else:
            res = ransac_registration(kp0, kp1[nn01], ok0, distance_threshold, **kw)
            es_T = inverse(res.transformation)   # T maps 0→1; gt.log wants 1→0
        err = transform_error(T_gt, covariance, es_T)
        accepted = err < 0.2 ** 2
        rre, rte = registration_error(T_gt, es_T)
        ir = inlier_ratio(apply_transform(kp1, es_T), kp1, T_gt, valid=ok1,
                          positive_radius=inlier_thresh)

        back = nn01[nn10]
        mutual = (back == torch.arange(kd1.shape[0], device=back.device)) & ok1
        m0 = kp0[nn10]
        moved1 = apply_transform(kp1, T_gt)
        d = torch.linalg.vector_norm(m0 - moved1, dim=-1)
        w = mutual.float()
        num_inl = ((d < inlier_thresh).float() * w).sum()
        ratio = num_inl / w.sum().clamp_min(1.0)
        zero = torch.zeros_like(rre)
        return {
            "accepted": accepted,
            "rr": accepted.float(),
            "rre": torch.where(accepted, rre, zero),
            "rte": torch.where(accepted, rte, zero),
            "rre_raw": rre,
            "rte_raw": rte,
            "ir": ir,
            "num_inliers": num_inl,
            "inlier_ratio_mutual": ratio,
            "fitness": res.fitness,
            "transformation": es_T,
        }

    register_kp.sample_shape = sample_shape(num_hypotheses, hypo_block, ransac_n)
    return register_kp


def make_pair_registration(*, num_keypoints: int = 5000, voxel_size: float = 0.025,
                           ransac_n: int = 3, num_hypotheses: int = 50000,
                           inlier_thresh: float = 0.1, hypo_block: int = 12500,
                           distance_multiplier: float = 1.5):
    """Returns register(xyz0, f0, n0, xyz1, f1, n1, T_gt, cov, *, generator,
    keypoint_u, samples) → the metrics dict of ``register_kp``: keypoints
    sampled from the valid rows of each side, then ``register_kp``. The
    draws come from ``generator``, made before the rest in the order the
    steps would make them (both sides' keys, then RANSAC's uniforms);
    ``keypoint_u`` (two uniform key vectors, one per side) and ``samples``
    (RANSAC sample indices, or the uniforms they are made from) replace
    them.

    As the JAX package jits it (``imfnet_tpu/eval/registration.py:145``),
    the rest is one CUDA graph per signature on the card
    (``utils.graphs.jit``; ``register.graphed``) and eager on the CPU. The
    card's result is the graph's outputs, cloned. ``register.body(xyz0, f0,
    n0, xyz1, f1, n1, T_gt, cov, u0, u1, samples)`` is what the graph holds
    and ``register.draws(xyz0, xyz1, generator)`` the draws it takes
    ((u0, u1), samples), for a caller that puts more into one graph
    (``eval.kitti``)."""
    register_kp = make_keypoint_registration(
        voxel_size=voxel_size, ransac_n=ransac_n,
        num_hypotheses=num_hypotheses, inlier_thresh=inlier_thresh,
        hypo_block=hypo_block, distance_multiplier=distance_multiplier)

    def keys(xyz0, xyz1, generator):
        return tuple(torch.rand(x.shape[0], generator=generator, device=x.device)
                     for x in (xyz0, xyz1))

    def uniforms(dev, generator):
        return torch.rand(register_kp.sample_shape, generator=generator, device=dev)

    def draws(xyz0, xyz1, generator=None):
        return keys(xyz0, xyz1, generator), uniforms(xyz0.device, generator)

    def body(xyz0, f0, n0, xyz1, f1, n1, T_gt, covariance, u0, u1, samples):
        timer.stage("registration.keypoints")
        v0 = torch.arange(xyz0.shape[0], device=xyz0.device) < n0
        v1 = torch.arange(xyz1.shape[0], device=xyz1.device) < n1
        i0, ok0 = sample_keypoints(v0, num_keypoints, u=u0)
        i1, ok1 = sample_keypoints(v1, num_keypoints, u=u1)
        return register_kp(xyz0[i0], f0[i0], ok0, xyz1[i1], f1[i1], ok1, T_gt,
                           covariance, samples=samples)

    graphed = jit(body, clone=True)

    def register(xyz0, f0, n0, xyz1, f1, n1, T_gt, covariance, *,
                 generator: Optional[torch.Generator] = None,
                 keypoint_u=None, samples=None):
        dev = xyz0.device
        if keypoint_u is None:
            keypoint_u = keys(xyz0, xyz1, generator)
        if samples is None:
            samples = uniforms(dev, generator)
        args = [xyz0, f0, n0, xyz1, f1, n1, T_gt, covariance, *keypoint_u, samples]
        if dev.type != "cuda":
            return body(*args)
        # counts and poses given on the host become device tensors here,
        # outside the graph
        args = [torch.as_tensor(a, device=dev) for a in args]
        return graphed(*args)

    register.graphed = graphed
    register.body = body
    register.draws = draws
    return register
