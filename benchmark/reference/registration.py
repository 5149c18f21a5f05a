"""Keypoint registration, plain PyTorch: keypoint sampling from given
uniform keys, descriptor nearest neighbours, RANSAC from given uniforms,
and the mutual-nearest inlier count of FMR (`scripts/evaluation_3dmatch.py:89-236`,
`scripts/benchmark_util.py:16-34`).

RANSAC follows the registration the configurations state: ``ransac_n``
correspondences a hypothesis, the edge-length checker (ratio 0.9, both
ways) and the distance checker, hypotheses in blocks each keeping its best
by inliers, then rmse, on a 512-row subset of the correspondences; the
block winner with the most inliers over all rows wins, refitted on its
inliers where that keeps as many. The rigid fit is Horn's quaternion
method: the dominant eigenvector from the characteristic quartic for the
hypotheses, from repeated squaring for the refit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from reference.precision import Precision


# ---- keypoints and nearest neighbours -------------------------------------

def sample_rows(eligible: torch.Tensor, u: torch.Tensor, k: int):
    """k rows without replacement: the eligible rows ordered by their
    uniform key, the rest last. Returns (rows int64[k], ok bool[k])."""
    keys = torch.where(eligible, u, torch.full_like(u, 2.0))
    rows = torch.sort(keys).indices[:k]
    ok = torch.arange(k, device=u.device) < min(int(eligible.sum()), k)
    return rows, ok


def nearest(q: torch.Tensor, r: torch.Tensor, r_valid: torch.Tensor,
            prec: Precision, block: int = 4096) -> torch.Tensor:
    """int64[N]: for each query the valid reference nearest in squared L2
    (the first on a tie)."""
    qr, rr = prec.round(q), prec.round(r)
    r2 = (rr * rr).sum(1)
    r2 = torch.where(r_valid, r2, torch.full_like(r2, float("inf")))
    out = torch.empty(len(q), dtype=torch.int64, device=q.device)
    for s in range(0, len(q), block):
        qb = qr[s:s + block]
        d2 = (qb * qb).sum(1, keepdim=True) + r2[None] - 2.0 * (qb @ rr.T)
        out[s:s + block] = d2.argmin(dim=1)
    return out


# ---- rigid fit (Horn) ------------------------------------------------------

def _dominant_quat(K):
    tr2 = sum(K[i][j] * K[i][j] for i in range(4) for j in range(4))
    K2 = [[sum(K[i][m] * K[m][j] for m in range(4)) for j in range(4)] for i in range(4)]
    tr3 = sum(K2[i][j] * K[j][i] for i in range(4) for j in range(4))

    def det3(M, rows, cols):
        (a, b, c), (p, q, s) = rows, cols
        return (M[a][p] * (M[b][q] * M[c][s] - M[b][s] * M[c][q])
                - M[a][q] * (M[b][p] * M[c][s] - M[b][s] * M[c][p])
                + M[a][s] * (M[b][p] * M[c][q] - M[b][q] * M[c][p]))

    idx = range(4)

    def minor(M, r, c):
        return det3(M, [i for i in idx if i != r], [j for j in idx if j != c])

    det = (K[0][0] * minor(K, 0, 0) - K[0][1] * minor(K, 0, 1)
           + K[0][2] * minor(K, 0, 2) - K[0][3] * minor(K, 0, 3))
    b, c, d = -0.5 * tr2, -tr3 / 3.0, det
    s0 = torch.sqrt(torch.clamp_min(tr2, 1e-30))
    lam = torch.ones_like(s0)
    bn, cn, dn = b / (s0 * s0), c / (s0 * s0 * s0), d / (s0 ** 4)
    for _ in range(12):      # Newton on the quartic, from above its largest root
        p = ((lam * lam + bn) * lam + cn) * lam + dn
        dp = (4.0 * lam * lam + 2.0 * bn) * lam + cn
        tiny = torch.where(dp < 0, -1e-20, 1e-20)
        lam = lam - p / torch.where(torch.abs(dp) < 1e-20, tiny, dp)
    lam = lam * s0
    B = [[(K[i][j] - lam if i == j else K[i][j]) for j in idx] for i in idx]
    adj = [[(1.0 if (i + j) % 2 == 0 else -1.0) * minor(B, j, i) for j in idx] for i in idx]
    best = adj[0][0]
    q = list(adj[0])
    for i in (1, 2, 3):
        take = torch.abs(adj[i][i]) > torch.abs(best)
        best = torch.where(take, adj[i][i], best)
        q = [torch.where(take, adj[i][j], q[j]) for j in idx]
    degenerate = torch.abs(best) < 1e-6 * (s0 * s0 * s0)
    v0 = (0.7, 0.5, 0.4, 0.3)
    q = [torch.where(degenerate, x + v0[i], x) for i, x in enumerate(q)]
    qn = torch.rsqrt(torch.clamp_min(sum(x * x for x in q), 1e-30))
    q = [x * qn for x in q]
    for _ in range(3):       # shifted power steps into the eigenspace
        q = [sum(K[i][j] * q[j] for j in idx) + s0 * q[i] for i in idx]
        qn = torch.rsqrt(torch.clamp_min(sum(x * x for x in q), 1e-30))
        q = [x * qn for x in q]
    return q


def _dominant_quat_squaring(K, squarings: int = 8):
    """The same eigenvector by repeated squaring of the shifted, scaled
    matrix (2^8 power steps), then one step against the shifted matrix."""
    idx = range(4)
    shift = torch.sqrt(sum(K[i][j] * K[i][j] for i in idx for j in idx)) + 1e-9
    Ks = [[(K[i][j] + shift if i == j else K[i][j]) for j in idx] for i in idx]
    M = [[Ks[i][j] / shift for j in idx] for i in idx]
    for _ in range(squarings):
        S = [[sum(M[i][m] * M[m][j] for m in idx) for j in idx] for i in idx]
        inv = torch.rsqrt(torch.clamp_min(sum(S[i][j] * S[i][j] for i in idx for j in idx),
                                          1e-30))
        M = [[S[i][j] * inv for j in idx] for i in idx]
    v0 = (0.7, 0.5, 0.4, 0.3)
    q = [sum(M[i][j] * v0[j] for j in idx) for i in idx]
    qn = torch.rsqrt(torch.clamp_min(sum(x * x for x in q), 1e-24))
    q = [x * qn for x in q]
    q = [sum(Ks[i][j] * q[j] for j in idx) for i in idx]
    qn = torch.rsqrt(torch.clamp_min(sum(x * x for x in q), 1e-24))
    return [x * qn for x in q]


def rigid_fit(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor = None,
              squaring: bool = False):
    """(R [..,3,3], t [..,3]) minimizing the weighted sum of
    |R src + t - dst|^2 over the points of the last-but-one axis: the
    quartic's root for RANSAC's hypotheses, repeated squaring
    (``squaring``) for the refit on a winner's inliers, as the
    registration the configurations state fits them."""
    if w is None:
        w = torch.ones(src.shape[:-1], device=src.device)
    wn = w / torch.clamp_min(w.sum(-1), 1e-12)[..., None]
    s = [src[..., i] for i in range(3)]
    d = [dst[..., i] for i in range(3)]
    ms = [(wn * s[i]).sum(-1) for i in range(3)]
    md = [(wn * d[i]).sum(-1) for i in range(3)]
    H = [[(wn * s[i] * d[j]).sum(-1) - ms[i] * md[j] for j in range(3)] for i in range(3)]
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
    qw, qx, qy, qz = _dominant_quat_squaring(K) if squaring else _dominant_quat(K)
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)
    t = torch.stack(md, -1) - (R @ torch.stack(ms, -1)[..., None])[..., 0]
    return R, t


def to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


# ---- RANSAC ----------------------------------------------------------------

def ransac(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor, thresh: float,
           u: torch.Tensor, edge_ratio: float = 0.9) -> torch.Tensor:
    """Best transform src -> dst (4x4) from the hypotheses that the uniforms
    ``u [n_blocks, block, ransac_n]`` name among the valid rows in order."""
    n_blocks, block, n = u.shape
    comp = torch.nonzero(valid).squeeze(1)
    n_valid = len(comp)
    hi = max(n_valid, 1)
    samples = torch.minimum((u * hi).long(), torch.full_like(u, hi - 1, dtype=torch.long))
    if n_valid == 0:
        comp = torch.zeros(1, dtype=torch.long, device=src.device)
    rows = comp[samples.reshape(-1, n)]
    s, d = src[rows], dst[rows]                                   # [H, n, 3]
    ok = torch.ones(len(s), dtype=torch.bool, device=src.device)
    r2 = edge_ratio ** 2
    for a in range(n):
        for b in range(a + 1, n):
            ls = ((s[:, a] - s[:, b]) ** 2).sum(-1)
            ld = ((d[:, a] - d[:, b]) ** 2).sum(-1)
            ok &= (ls > r2 * ld) & (ld > r2 * ls)
    R, t = rigid_fit(s, d)
    T = to_matrix(R, t)                                           # [H, 4, 4]
    ok &= (((apply(T, s) - d) ** 2).sum(-1) <= thresh ** 2).all(-1)
    # the validation subset: 512 rows spread over the valid ones
    m = min(512, len(src))
    sub = comp[(torch.arange(m, device=src.device) * hi) // m]
    s_sub, d_sub, v_sub = src[sub], dst[sub], valid[sub]
    score = torch.empty(len(T), device=src.device)
    for h0 in range(0, len(T), 4096):
        d2 = ((apply(T[h0:h0 + 4096], s_sub[None]) - d_sub[None]) ** 2).sum(-1)
        inl = (d2 <= thresh ** 2) & v_sub[None]
        cnt = inl.sum(1)
        rmse = torch.sqrt(torch.where(inl, d2, torch.zeros_like(d2)).sum(1)
                          / cnt.clamp_min(1).float())
        score[h0:h0 + 4096] = torch.where(ok[h0:h0 + 4096] & (cnt > 0),
                                          cnt.float() - rmse / (rmse + 1.0),
                                          torch.full_like(rmse, -1.0))
    win = torch.arange(n_blocks, device=src.device) * block + score.view(n_blocks, block).argmax(1)
    cand, cand_score = T[win], score[win]
    full = torch.stack([inliers(c, src, dst, valid, thresh).sum() for c in cand])
    full = torch.where(cand_score > 0, full, torch.full_like(full, -1))
    best = cand[int(full.argmax())]
    inl = inliers(best, src, dst, valid, thresh)
    R, t = rigid_fit(src, dst, inl.float(), squaring=True)
    refit = to_matrix(R, t)
    if inliers(refit, src, dst, valid, thresh).sum() >= inl.sum():
        best = refit
    return best


def inliers(T, src, dst, valid, thresh) -> torch.Tensor:
    return (((apply(T, src) - dst) ** 2).sum(-1) <= thresh ** 2) & valid


# ---- metrics ---------------------------------------------------------------

def mutual_inliers(kp0, kp1, nn01, nn10, ok1, T_gt, inlier_thresh) -> int:
    """Mutual nearest pairs whose points lie within ``inlier_thresh``
    under the ground truth."""
    back = nn01[nn10]
    mutual = (back == torch.arange(len(nn10), device=back.device)) & ok1
    d = (kp0[nn10] - apply(T_gt.float(), kp1)).norm(dim=-1)
    return int(((d < inlier_thresh) & mutual).sum())


def keypoint_pairs(kd0, kd1, ok0, ok1, prec) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nn01, nn10) of the keypoints' descriptors."""
    return nearest(kd0, kd1, ok1, prec), nearest(kd1, kd0, ok0, prec)
