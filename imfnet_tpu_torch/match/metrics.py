"""Registration metrics (`lib/metrics.py:13-29`, `util/uio.py:102-198`)."""
from __future__ import annotations

import math

import torch

from imfnet_tpu_torch.match.procrustes import rotmat_to_quat


def apply_transform(pts: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """pts [..,N,3], T [..,4,4] → R pts + t."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def pdist_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full squared-L2 distance matrix [N,M]."""
    a, b = a.float(), b.float()
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    return torch.clamp_min(sq - 2.0 * (a @ b.T), 0.0)


def corr_dist(T_est, T_gt, xyz, valid=None, max_dist: float = 1.0):
    """Mean clipped distance between xyz under est vs gt transform."""
    d = torch.linalg.vector_norm(
        apply_transform(xyz, T_est) - apply_transform(xyz, T_gt), dim=-1)
    d = torch.clamp_max(d, max_dist)
    if valid is None:
        return d.mean()
    w = valid.float()
    return (d * w).sum() / torch.clamp_min(w.sum(), 1.0)


def relative_rotation_error(R_gt, R_est, degrees: bool = True):
    """acos((trace(R_estᵀ R_gt) − 1)/2)."""
    m = R_est.transpose(-1, -2) @ R_gt
    x = 0.5 * (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0)
    ang = torch.arccos(torch.clamp(x, -1.0, 1.0))
    return ang * (180.0 / math.pi) if degrees else ang


def relative_translation_error(t_gt, t_est):
    return torch.linalg.vector_norm(t_gt - t_est, dim=-1)


def registration_error(T_gt, T_est, degrees: bool = True):
    """(RRE, RTE)."""
    rre = relative_rotation_error(T_gt[..., :3, :3], T_est[..., :3, :3], degrees)
    rte = relative_translation_error(T_gt[..., :3, 3], T_est[..., :3, 3])
    return rre, rte


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Matrix inverse without a host sync (``torch.linalg.inv`` checks for
    singular input, which waits for the device)."""
    return torch.linalg.inv_ex(T)[0]


def transform_error(T_gt, covariance, T_est):
    """Covariance-weighted pose error for Registration Recall: p = eᵀ Σ e /
    Σ₀₀ with e = [t, q_xyz] of T_gt⁻¹ T_est; accepted when p < 0.2²."""
    rel = inverse(T_gt) @ T_est
    q = rotmat_to_quat(rel[..., :3, :3])
    e = torch.cat([rel[..., :3, 3], q[..., 1:]], dim=-1)
    return torch.einsum("...i,...ij,...j->...", e, covariance, e) / covariance[..., 0, 0]


def inlier_ratio(ref_pts, src_pts, T_gt, valid=None, positive_radius: float = 0.1):
    """Fraction of correspondences within radius after the gt transform."""
    moved = apply_transform(src_pts, T_gt)
    d = torch.linalg.vector_norm(ref_pts - moved, dim=-1)
    ok = (d < positive_radius).float()
    if valid is None:
        return ok.mean()
    w = valid.float()
    return (ok * w).sum() / torch.clamp_min(w.sum(), 1.0)


def hit_ratio(xyz0, xyz1, T_gt, valid=None, thresh: float = 0.1):
    """`ContrastiveLossTrainer.evaluate_hit_ratio` (`lib/trainer.py:432-435`)."""
    moved = apply_transform(xyz0, T_gt)
    d = torch.sqrt(((moved - xyz1) ** 2).sum(dim=-1) + 1e-6)
    ok = (d < thresh).float()
    if valid is None:
        return ok.mean()
    w = valid.float()
    return (ok * w).sum() / torch.clamp_min(w.sum(), 1.0)
