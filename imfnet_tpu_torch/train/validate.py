"""Validation step: correspondence fit and registration metrics
(``imfnet_tpu.train.validate``).

The per-pair body of `ContrastiveLossTrainer._valid_epoch`
(`lib/trainer.py:332-414`): eval-mode forwards, a 5000-point subsample,
descriptor NN (`find_corr`, :416-430), the IRLS pose fit
(`util/transform_estimation.py:89-116`), then loss/RTE/RRE/success/
hit-ratio/feat-match-ratio. Runs with a batch of one pair.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.match.irls import est_rigid_irls
from imfnet_tpu_torch.match.metrics import apply_transform, corr_dist, registration_error
from imfnet_tpu_torch.match.nn import nn_auto
from imfnet_tpu_torch.sparse.coords import row_mask
from imfnet_tpu_torch.train.losses import _sample_without_replacement
from imfnet_tpu_torch.train.step import PairBatch, forward_pair


def make_val_step(model, config: Config, subsample_size: Optional[int] = None,
                  map_impl: Optional[str] = None):
    """val_step(batch, generator=None, draws=None) → metrics (0-d tensors).
    ``map_impl`` picks how the pyramid is built (``train.step.forward_pair``).
    ``subsample_size`` defaults to config.val_subsample_size (the
    reference's 5000, `lib/trainer.py:419`), capped by the pad capacity as
    the reference's min(N, 5000); ``draws`` (u[N0], u[N1]) replaces the
    subsample's uniform scores."""
    if subsample_size is None:
        subsample_size = config.val_subsample_size
    subsample_size = min(subsample_size, config.max_points)

    @torch.no_grad()
    def val_step(batch: PairBatch, generator: Optional[torch.Generator] = None,
                 draws: Optional[Sequence[torch.Tensor]] = None):
        f0, f1 = forward_pair(model, batch, train=False, config=config,
                              map_impl=map_impl)
        v0 = row_mask(f0.shape[0], batch.n0)
        v1 = row_mask(f1.shape[0], batch.n1)
        u0, u1 = draws if draws is not None else (None, None)
        i0, ok0 = _sample_without_replacement(v0, subsample_size, generator, u0)
        i1, ok1 = _sample_without_replacement(v1, subsample_size, generator, u1)
        sx1 = batch.xyz1[i1]
        nn01 = nn_auto(f0[i0], f1[i1], ok1)[0].long()
        x0c, x1c = batch.xyz0[i0], sx1[nn01]

        T_est = est_rigid_irls(x0c, x1c, valid=ok0)
        T_gt = batch.T_gt[0]
        loss = corr_dist(T_est, T_gt, batch.xyz0, valid=v0)
        rre, rte = registration_error(T_gt, T_est)
        success = (rte < 2.0) & (rre < 5.0)

        d = torch.sqrt(((apply_transform(x0c, T_gt) - x1c) ** 2).sum(-1) + 1e-6)
        w = ok0.float()
        inl = (d < config.hit_ratio_thresh) * w
        hit = inl.sum() / w.sum().clamp_min(1.0)

        # how many ground-truth-consistent correspondences enter IRLS, and
        # how well its estimate fits them
        r_est = torch.sqrt(((apply_transform(x0c, T_est) - x1c) ** 2).sum(-1) + 1e-12)
        rs = torch.sort(torch.where(ok0, r_est, torch.full_like(r_est, float("inf")))).values
        n_ok = ok0.sum()
        med = rs[(n_ok // 2).clamp(0, rs.shape[0] - 1)]
        med = torch.where(n_ok > 0, med, torch.zeros_like(med))
        return {
            "loss": loss,
            "rre": rre,
            "rte": rte,
            "success": success.float(),
            "hit_ratio": hit,
            "feat_match_ratio": (hit > 0.05).float(),
            "corr_inliers": inl.sum(),
            "irls_resid_med": med,
            "irls_resid_inlier": (r_est * inl).sum() / inl.sum().clamp_min(1.0),
        }

    return val_step
