"""Batched RANSAC rigid registration on correspondences (Open3D's
`registration_ransac_based_on_feature_matching` as configured by
`scripts/benchmark_util.py:16-34`): ransac_n samples per hypothesis,
edge-length checker (ratio 0.9, both directions) and distance checker, a
fixed batch of hypotheses scored at once, then a least-squares refit on the
best model's inliers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from imfnet_tpu_torch.match.metrics import apply_transform
from imfnet_tpu_torch.match.procrustes import (kabsch_umeyama, kabsch_umeyama_soa,
                                               soa_to_matrix)


class RansacResult(NamedTuple):
    transformation: torch.Tensor  # [4,4]
    fitness: torch.Tensor         # inliers / valid correspondences
    inlier_rmse: torch.Tensor
    inlier_mask: torch.Tensor     # bool[C]


def _compact_valid(valid: torch.Tensor):
    """Indices of valid rows compacted to the front, and their count."""
    c = valid.shape[0]
    pos = torch.cumsum(valid.long(), 0) - 1
    tgt = torch.where(valid, pos, torch.full_like(pos, c))
    comp = torch.zeros(c + 1, dtype=torch.long, device=valid.device)
    comp.scatter_(0, tgt, torch.arange(c, device=valid.device))
    return comp[:c], valid.long().sum()


def sample_shape(num_hypotheses: int, hypo_block: int, ransac_n: int):
    """(n_blocks, hypo_block, ransac_n): the shape of RANSAC's samples."""
    return (-(-num_hypotheses // hypo_block), hypo_block, ransac_n)


def samples_from_uniform(u: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Sample indices in [0, max(n_valid, 1)) from uniforms of the same shape."""
    hi = n_valid.clamp_min(1)
    return torch.minimum((u * hi).long(), hi - 1)


def draw_samples(n_valid: torch.Tensor, n_blocks: int, hypo_block: int,
                 ransac_n: int, generator: Optional[torch.Generator] = None):
    """Uniform sample indices in [0, max(n_valid, 1)), long[n_blocks,
    hypo_block, ransac_n], drawn on n_valid's device without a host sync."""
    u = torch.rand((n_blocks, hypo_block, ransac_n), generator=generator,
                   device=n_valid.device)
    return samples_from_uniform(u, n_valid)


def ransac_registration(
    src: torch.Tensor,            # [C,3] source points of the correspondences
    dst: torch.Tensor,            # [C,3] matched target points
    valid: torch.Tensor,          # bool[C]
    distance_threshold: float,
    *,
    ransac_n: int = 3,
    num_hypotheses: int = 50000,
    edge_length_ratio: float = 0.9,
    hypo_block: int = 12500,
    refine: bool = True,
    fit_power_iters: int = 0,
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
) -> RansacResult:
    """Best rigid transform src → dst. Hypothesis samples are indices into
    the compacted valid rows, ``int[n_blocks, hypo_block, ransac_n]``: drawn
    from ``generator`` unless ``samples`` injects them (or the uniforms
    ``draw_samples`` makes them from, as floats). Each block keeps its
    best hypothesis (inlier count then rmse on a 512-row validation subset);
    the block winner with the most inliers over all rows wins."""
    c = src.shape[0]
    src, dst = src.float(), dst.float()
    comp, n_valid = _compact_valid(valid)
    n_blocks = -(-num_hypotheses // hypo_block)
    if samples is None:
        samples = draw_samples(n_valid, n_blocks, hypo_block, ransac_n, generator)
    if samples.shape != (n_blocks, hypo_block, ransac_n):
        raise ValueError(f"samples must be [{n_blocks}, {hypo_block}, "
                         f"{ransac_n}], got {tuple(samples.shape)}")
    if samples.is_floating_point():
        samples = samples_from_uniform(samples, n_valid)

    n_subset = min(512, c)
    sub_rows = comp[(torch.arange(n_subset, device=src.device)
                     * n_valid.clamp_min(1)) // n_subset]
    sub_src, sub_dst, sub_valid = src[sub_rows], dst[sub_rows], valid[sub_rows]
    sd_c = torch.cat([src[comp], dst[comp]], dim=1)              # [C,6]

    # all blocks at once: rows are (block, hypothesis)
    sd = sd_c[samples.reshape(-1, ransac_n).long()]              # [H,n,6]
    s, d = sd[..., :3], sd[..., 3:]
    h = s.shape[0]
    edge_ok = torch.ones(h, dtype=torch.bool, device=src.device)
    ratio2 = edge_length_ratio ** 2
    for a in range(ransac_n):
        for b_ in range(a + 1, ransac_n):
            ls2 = ((s[:, a] - s[:, b_]) ** 2).sum(dim=-1)
            ld2 = ((d[:, a] - d[:, b_]) ** 2).sum(dim=-1)
            edge_ok &= (ls2 > ratio2 * ld2) & (ld2 > ratio2 * ls2)
    R, t3 = kabsch_umeyama_soa(s, d, power_iters=fit_power_iters)
    samp_ok = torch.ones(h, dtype=torch.bool, device=src.device)
    for p in range(ransac_n):
        dd = torch.zeros(h, device=src.device)
        for i in range(3):
            mi = (R[i][0] * s[:, p, 0] + R[i][1] * s[:, p, 1]
                  + R[i][2] * s[:, p, 2] + t3[i])
            dd += (mi - d[:, p, i]) ** 2
        samp_ok &= dd <= distance_threshold ** 2
    ok = edge_ok & samp_ok
    sx, sy, sz = (sub_src[None, :, i] for i in range(3))
    d2 = torch.zeros((h, n_subset), device=src.device)
    for i in range(3):
        mi = (R[i][0][:, None] * sx + R[i][1][:, None] * sy
              + R[i][2][:, None] * sz + t3[i][:, None])
        d2 += (mi - sub_dst[None, :, i]) ** 2
    inl = (d2 <= distance_threshold ** 2) & sub_valid[None, :]
    count = inl.sum(dim=1)
    rmse = torch.sqrt(torch.where(inl, d2, torch.zeros_like(d2)).sum(dim=1)
                      / count.clamp_min(1).float())
    score = torch.where(ok & (count > 0),
                        count.float() - rmse / (rmse + 1.0),
                        torch.full_like(rmse, -1.0))
    T_all = soa_to_matrix(R, t3)                                  # [H,4,4]
    b = score.reshape(n_blocks, hypo_block).argmax(dim=1)         # per block
    rows = torch.arange(n_blocks, device=src.device) * hypo_block + b
    block_scores, block_Ts = score[rows], T_all[rows]

    moved_all = apply_transform(src[None], block_Ts)              # [nb,C,3]
    d2_all = ((moved_all - dst[None]) ** 2).sum(dim=-1)
    full_counts = ((d2_all <= distance_threshold ** 2) & valid[None, :]).sum(dim=1)
    full_counts = torch.where(block_scores > 0, full_counts,
                              torch.full_like(full_counts, -1))
    # an index tensor, not a 0-d one: that would be read back to the host
    best_T = block_Ts.index_select(0, full_counts.argmax().reshape(1))[0]

    def inliers_of(T):
        d2 = ((apply_transform(src, T) - dst) ** 2).sum(dim=-1)
        return (d2 <= distance_threshold ** 2) & valid, d2

    inl, d2 = inliers_of(best_T)
    if refine:
        refit = kabsch_umeyama(src, dst, weights=inl.float())
        inl_r, d2_r = inliers_of(refit)
        use = inl_r.sum() >= inl.sum()
        best_T = torch.where(use, refit, best_T)
        inl = torch.where(use, inl_r, inl)
        d2 = torch.where(use, d2_r, d2)

    count = inl.sum()
    fitness = count / valid.sum().clamp_min(1)
    rmse = torch.sqrt(torch.where(inl, d2, torch.zeros_like(d2)).sum()
                      / count.clamp_min(1))
    return RansacResult(best_T, fitness, rmse, inl)
