"""Weighted rigid alignment (Kabsch/Umeyama) via Horn's quaternion method.

Batched and branch-free: the rotation is the dominant eigenvector of Horn's
4x4 K matrix, from the closed-form characteristic quartic
(``power_iters=0``) or from repeated matrix squaring. Components stay
separate [..] tensors (structure of arrays), so tens of thousands of RANSAC
hypotheses fit at once.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) [..,4] → rotation matrix [..,3,3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..,3,3] → unit quaternion (w,x,y,z) with w >= 0,
    branch-free: four candidates, the best-conditioned one chosen."""
    m = R
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    qs = []
    w = torch.sqrt(torch.clamp_min(1.0 + t, 1e-12)) / 2
    qs.append(torch.stack([
        w,
        (m[..., 2, 1] - m[..., 1, 2]) / (4 * w),
        (m[..., 0, 2] - m[..., 2, 0]) / (4 * w),
        (m[..., 1, 0] - m[..., 0, 1]) / (4 * w),
    ], dim=-1))
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        s = torch.sqrt(torch.clamp_min(
            1.0 + m[..., i, i] - m[..., j, j] - m[..., k, k], 1e-12)) * 2
        q = [None] * 4
        q[0] = (m[..., k, j] - m[..., j, k]) / s
        q[i + 1] = s / 4
        q[j + 1] = (m[..., j, i] + m[..., i, j]) / s
        q[k + 1] = (m[..., k, i] + m[..., i, k]) / s
        qs.append(torch.stack(q, dim=-1))
    cand = torch.stack(qs, dim=-2)  # [..,4cand,4]
    mags = torch.stack([1.0 + t, 1.0 + 2 * m[..., 0, 0] - t,
                        1.0 + 2 * m[..., 1, 1] - t, 1.0 + 2 * m[..., 2, 2] - t],
                       dim=-1)
    best = torch.argmax(mags, dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
    return q * torch.where(q[..., :1] >= 0, 1.0, -1.0)


def _dominant_quat_newton(K):
    """Dominant eigenvector of Horn's symmetric traceless 4x4 K (nested
    lists of [..] tensors) from the characteristic quartic
    λ⁴ + bλ² + cλ + d: Newton from λ₀ = ‖K‖_F converges to λmax, and the
    eigenvector is the largest-diagonal row of adj(K − λmax I). A
    (near-)repeated λmax collapses the adjugate; there a fixed seed is
    blended in and shifted power steps converge into the eigenspace."""
    tr2 = sum(K[i][j] * K[i][j] for i in range(4) for j in range(4))
    K2 = [[sum(K[i][m] * K[m][j] for m in range(4)) for j in range(4)]
          for i in range(4)]
    tr3 = sum(K2[i][j] * K[j][i] for i in range(4) for j in range(4))

    def det3(r, c):
        rs = [i for i in range(4) if i != r]
        cs = [j for j in range(4) if j != c]
        a, b_, c_ = rs
        p, q, s = cs
        return (K[a][p] * (K[b_][q] * K[c_][s] - K[b_][s] * K[c_][q])
                - K[a][q] * (K[b_][p] * K[c_][s] - K[b_][s] * K[c_][p])
                + K[a][s] * (K[b_][p] * K[c_][q] - K[b_][q] * K[c_][p]))

    det = (K[0][0] * det3(0, 0) - K[0][1] * det3(0, 1)
           + K[0][2] * det3(0, 2) - K[0][3] * det3(0, 3))
    b = -0.5 * tr2
    c = -tr3 / 3.0
    d = det
    s0 = torch.sqrt(torch.clamp_min(tr2, 1e-30))
    lam = torch.ones_like(s0)
    bn, cn, dn = b / (s0 * s0), c / (s0 * s0 * s0), d / (s0 ** 4)
    for _ in range(12):
        p = ((lam * lam + bn) * lam + cn) * lam + dn
        dp = (4.0 * lam * lam + 2.0 * bn) * lam + cn
        tiny = torch.where(dp < 0, -1e-20, 1e-20)
        lam = lam - p / torch.where(torch.abs(dp) < 1e-20, tiny, dp)
    lam = lam * s0
    B = [[(K[i][j] - lam if i == j else K[i][j]) for j in range(4)]
         for i in range(4)]

    def cof3(rows, cols):
        (a, b_, c_), (p, q, s) = rows, cols
        return (B[a][p] * (B[b_][q] * B[c_][s] - B[b_][s] * B[c_][q])
                - B[a][q] * (B[b_][p] * B[c_][s] - B[b_][s] * B[c_][p])
                + B[a][s] * (B[b_][p] * B[c_][q] - B[b_][q] * B[c_][p]))

    idx = list(range(4))
    adj = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(4):
            sign = 1.0 if (i + j) % 2 == 0 else -1.0
            adj[i][j] = sign * cof3([r for r in idx if r != j],
                                    [cc for cc in idx if cc != i])
    best_d = adj[0][0]
    q = list(adj[0])
    for i in (1, 2, 3):
        take = torch.abs(adj[i][i]) > torch.abs(best_d)
        best_d = torch.where(take, adj[i][i], best_d)
        q = [torch.where(take, adj[i][j], q[j]) for j in range(4)]
    degenerate = torch.abs(best_d) < 1e-6 * (s0 * s0 * s0)
    v0 = (0.7, 0.5, 0.4, 0.3)
    q = [torch.where(degenerate, x + v0[i], x) for i, x in enumerate(q)]
    qn = torch.rsqrt(torch.clamp_min(sum(x * x for x in q), 1e-30))
    q = [x * qn for x in q]
    for _ in range(3):
        q = [sum(K[i][j] * q[j] for j in range(4)) + s0 * q[i]
             for i in range(4)]
        qn = torch.rsqrt(torch.clamp_min(sum(x * x for x in q), 1e-30))
        q = [x * qn for x in q]
    return q


def kabsch_umeyama_soa(src: torch.Tensor, dst: torch.Tensor,
                       weights: torch.Tensor | None = None,
                       power_iters: int = 16):
    """Structure-of-arrays Kabsch: (R, t) with R a 3x3 nested list of [..]
    tensors and t a list of 3, such that R src + t ≈ dst.
    ``power_iters=0`` selects the closed-form quartic eigensolver."""
    src, dst = src.float(), dst.float()
    if weights is None:
        weights = torch.ones(src.shape[:-1], device=src.device)
    w = weights.float()
    wsum = torch.clamp_min(w.sum(dim=-1), 1e-12)
    wn = w / wsum[..., None]
    s = [src[..., :, 0], src[..., :, 1], src[..., :, 2]]
    d = [dst[..., :, 0], dst[..., :, 1], dst[..., :, 2]]
    mu_s = [(wn * s[i]).sum(dim=-1) for i in range(3)]
    mu_d = [(wn * d[i]).sum(dim=-1) for i in range(3)]
    H = [[(wn * s[i] * d[j]).sum(dim=-1) - mu_s[i] * mu_d[j]
          for j in range(3)] for i in range(3)]
    tr = H[0][0] + H[1][1] + H[2][2]
    K = [[None] * 4 for _ in range(4)]
    K[0][0] = tr
    K[0][1] = K[1][0] = H[1][2] - H[2][1]
    K[0][2] = K[2][0] = H[2][0] - H[0][2]
    K[0][3] = K[3][0] = H[0][1] - H[1][0]
    K[1][1] = H[0][0] - H[1][1] - H[2][2]
    K[1][2] = K[2][1] = H[0][1] + H[1][0]
    K[1][3] = K[3][1] = H[2][0] + H[0][2]
    K[2][2] = -H[0][0] + H[1][1] - H[2][2]
    K[2][3] = K[3][2] = H[1][2] + H[2][1]
    K[3][3] = -H[0][0] - H[1][1] + H[2][2]
    if power_iters == 0:
        qw, qx, qy, qz = _dominant_quat_newton(K)
    else:
        # shift so λmax is also largest in magnitude, then square repeatedly:
        # m squarings act like 2^m power iterations
        shift = torch.sqrt(sum(K[i][j] * K[i][j]
                               for i in range(4) for j in range(4))) + 1e-9
        Ks = [[(K[i][j] + shift if i == j else K[i][j]) for j in range(4)]
              for i in range(4)]
        M = [[Ks[i][j] / shift for j in range(4)] for i in range(4)]
        for _ in range(max(1, power_iters // 2)):
            S = [[(M[i][0] * M[0][j] + M[i][1] * M[1][j]
                   + M[i][2] * M[2][j] + M[i][3] * M[3][j])
                  for j in range(4)] for i in range(4)]
            inv = torch.rsqrt(torch.clamp_min(
                sum(S[i][j] * S[i][j] for i in range(4) for j in range(4)),
                1e-30))
            M = [[S[i][j] * inv for j in range(4)] for i in range(4)]
        v0 = (0.7, 0.5, 0.4, 0.3)
        q = [sum(M[i][j] * v0[j] for j in range(4)) for i in range(4)]
        qn = torch.rsqrt(torch.clamp_min(sum(x * x for x in q), 1e-24))
        q = [x * qn for x in q]
        # one exact polish step against the shifted matrix
        q = [sum(Ks[i][j] * q[j] for j in range(4)) for i in range(4)]
        qn = torch.rsqrt(torch.clamp_min(sum(x * x for x in q), 1e-24))
        qw, qx, qy, qz = (x * qn for x in q)
    R = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ]
    t = [mu_d[i] - (R[i][0] * mu_s[0] + R[i][1] * mu_s[1] + R[i][2] * mu_s[2])
         for i in range(3)]
    return R, t


def soa_to_matrix(R, t) -> torch.Tensor:
    """(R, t) component lists → [.., 4, 4] homogeneous transform."""
    zero = torch.zeros_like(t[0])
    one = torch.ones_like(t[0])
    rows = [torch.stack(list(R[i]) + [t[i]], dim=-1) for i in range(3)]
    rows.append(torch.stack([zero, zero, zero, one], dim=-1))
    return torch.stack(rows, dim=-2)


def kabsch_umeyama(src, dst, weights=None, power_iters: int = 16) -> torch.Tensor:
    """Weighted least-squares rigid transform T [..,4,4] with T src ≈ dst."""
    R, t = kabsch_umeyama_soa(src, dst, weights, power_iters)
    return soa_to_matrix(R, t)
