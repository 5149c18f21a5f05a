"""Robust IRLS rigid pose from weighted correspondences
(``imfnet_tpu.match.irls``).

The reference's validation-time pose solver `est_quad_linear_robust`
(`util/transform_estimation.py:89-116`): 20 iterations of a linearized
small-angle rigid solve with Cauchy-like weights w = par / (r + par), par
halved every 5 iterations, on 6x6 normal equations (the [3N,6] design
matrix is stacked per axis, never per point pair)."""
from __future__ import annotations

from typing import Optional

import torch


def _euler_trans(x: torch.Tensor) -> torch.Tensor:
    """T = [Rz(x2) Ry(x1) Rx(x0) | x3:6] (`util/transform_estimation.py:5-45`)."""
    c, s = torch.cos(x[:3]), torch.sin(x[:3])
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])
    Rx = torch.stack([one, zero, zero, zero, c[0], -s[0], zero, s[0], c[0]]).reshape(3, 3)
    Ry = torch.stack([c[1], zero, s[1], zero, one, zero, -s[1], zero, c[1]]).reshape(3, 3)
    Rz = torch.stack([c[2], -s[2], zero, s[2], c[2], zero, zero, zero, one]).reshape(3, 3)
    T = torch.eye(4, dtype=x.dtype, device=x.device)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = x[3:6]
    return T


def est_rigid_irls(
    pts0: torch.Tensor,                      # [N,3] source
    pts1: torch.Tensor,                      # [N,3] target
    weight: Optional[torch.Tensor] = None,   # [N]
    valid: Optional[torch.Tensor] = None,
    iters: int = 20,
    par0: float = 1.0,
) -> torch.Tensor:
    """T (4x4) with T @ pts0 ≈ pts1. No value is read back to the host."""
    pts0, pts1 = pts0.float(), pts1.float()
    w = torch.ones_like(pts0[:, 0]) if weight is None else weight.float()
    vmask = None if valid is None else valid.float()
    if vmask is not None:
        w = w * vmask
    eye6 = 1e-9 * torch.eye(6, device=pts0.device)

    def build_and_solve(p, w):
        """Normal-equation solve of the reference's stacked [A0;A1;A2] system
        (`util/transform_estimation.py:56-82`) with the per-row weight w."""
        x_, y_, z_ = p[:, 0], p[:, 1], p[:, 2]
        zero, one = torch.zeros_like(x_), torch.ones_like(x_)
        A0 = torch.stack([zero, z_, -y_, one, zero, zero], 1)
        A1 = torch.stack([-z_, zero, x_, zero, one, zero], 1)
        A2 = torch.stack([y_, -x_, zero, zero, zero, one], 1)
        w3 = w.repeat(3)[:, None]
        A = torch.cat([A0, A1, A2], 0) * w3
        b = torch.cat([pts1[:, 0] - x_, pts1[:, 1] - y_, pts1[:, 2] - z_], 0)[:, None] * w3
        # solve_ex: no singularity check, which would wait for the device
        return torch.linalg.solve_ex(A.T @ A + eye6, A.T @ b)[0][:, 0]

    p_curr, par = pts0, par0
    T = torch.eye(4, device=pts0.device)
    for i in range(iters):
        if i > 0 and i % 5 == 0:
            par = par / 2.0
        T_curr = _euler_trans(build_and_solve(p_curr, w))
        p_curr = p_curr @ T_curr[:3, :3].T + T_curr[:3, 3]
        r = torch.linalg.vector_norm(p_curr - pts1, dim=1)
        w = par / (r + par)
        if vmask is not None:
            w = w * vmask
        T = T_curr @ T
    return T
