"""The training step, plain PyTorch: both forwards on the batch's
statistics, the positive search, the hardest-contrastive loss
(`lib/trainer.py:440-492`, HardestContrastiveLossTrainer) with given
uniform draws, autograd's backward and SGD with momentum and coupled
weight decay (`lib/trainer.py:75-81`).

A side is a padded table: its first ``n`` rows are the voxels of the
batch's fragments of that side, sorted by (batch, x, y, z). Samplers take
the ``k`` rows of highest uniform score among the eligible ones.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from reference import model as ref_model
from reference import voxels as ref_vox
from reference.precision import Precision


class TrainSide(NamedTuple):
    coords: torch.Tensor     # int64[n, 4] sorted voxels (batch, x, y, z)
    xyz: torch.Tensor        # f32[n, 3] their points
    images: torch.Tensor     # f32[B, H, W, 3]
    n_pad: int


def positives(s0: TrainSide, s1: TrainSide, T_gt: torch.Tensor, radius: float):
    """(pairs int64[n_pad0, 2], ok bool[n_pad0]): each voxel of side 0, with
    its nearest side-1 voxel of the same pair after the ground truth, kept
    within ``radius``."""
    n0 = len(s0.coords)
    b0, b1 = s0.coords[:, 0], s1.coords[:, 0]
    x0 = torch.einsum("nij,nj->ni", T_gt[b0, :3, :3], s0.xyz) + T_gt[b0, :3, 3]
    idx = torch.zeros(n0, dtype=torch.int64, device=x0.device)
    d2 = torch.full((n0,), float("inf"), device=x0.device)
    for b in range(len(T_gt)):
        rows, refs = torch.nonzero(b0 == b).squeeze(1), torch.nonzero(b1 == b).squeeze(1)
        if len(rows) == 0 or len(refs) == 0:
            continue
        for a in range(0, len(rows), 1024):
            r = rows[a:a + 1024]
            dd = ((x0[r, None, :] - s1.xyz[None, refs, :]) ** 2).sum(-1)
            m, j = dd.min(dim=1)
            idx[r], d2[r] = refs[j], m
    pairs = torch.zeros((s0.n_pad, 2), dtype=torch.int64, device=x0.device)
    pairs[:, 0] = torch.arange(s0.n_pad, device=x0.device)
    pairs[:n0, 1] = idx
    ok = torch.zeros(s0.n_pad, dtype=torch.bool, device=x0.device)
    ok[:n0] = d2 <= radius * radius
    return pairs, ok


def _sample(valid: torch.Tensor, u: torch.Tensor, k: int):
    top, idx = torch.topk(torch.where(valid, u, torch.full_like(u, -1.0)), k)
    return idx, top >= 0.0


def _pdist(a, b):
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    return torch.sqrt(sq.clamp_min(0.0) + 1e-7)


def _masked_mean(x, m):
    w = m.float()
    return (x * w).sum() / w.sum().clamp_min(1.0)


def hardest_contrastive(f0, valid0, f1, valid1, pairs, pair_ok, draws, *, num_pos: int,
                        num_hn: int, pos_thresh: float, neg_thresh: float):
    """(pos_loss, neg_loss) over padded descriptors f0, f1."""
    sel0, ok0 = _sample(valid0, draws[0], num_hn)
    sel1, ok1 = _sample(valid1, draws[1], num_hn)
    psel, pok = _sample(pair_ok, draws[2], num_pos)
    pi, pj = pairs[psel, 0], pairs[psel, 1]
    pf0, pf1 = f0[pi], f1[pj]
    inf = torch.tensor(float("inf"), device=f0.device)
    d01 = torch.where(ok1[None], _pdist(pf0, f1[sel1]), inf)
    d10 = torch.where(ok0[None], _pdist(pf1, f0[sel0]), inf)
    d01_min, d01_arg = d01.min(1)
    d10_min, d10_arg = d10.min(1)
    keys = torch.sort(torch.where(pair_ok, pairs[:, 0] << 32 | pairs[:, 1],
                                  torch.full_like(pairs[:, 0], torch.iinfo(torch.int64).max))
                      ).values

    def member(i, j):
        q = i << 32 | j
        return keys[torch.searchsorted(keys, q).clamp_max(len(keys) - 1)] == q

    m0 = pok & ~member(pi, sel1[d01_arg])
    m1 = pok & ~member(sel0[d10_arg], pj)
    pos = _masked_mean(torch.relu(((pf0 - pf1) ** 2).sum(1) - pos_thresh), pok)
    neg = (_masked_mean(torch.relu(neg_thresh - d01_min) ** 2, m0)
           + _masked_mean(torch.relu(neg_thresh - d10_min) ** 2, m1)) / 2.0
    return pos, neg


def loss(P: Dict[str, torch.Tensor], m: Dict, sides: Tuple[TrainSide, TrainSide],
         T_gt: torch.Tensor, draws: List[torch.Tensor], c: Dict, prec: Precision,
         pairs_in_loss: Optional[int] = None):
    """(loss, pos_loss, descriptors of each side) of the step: both forwards
    in training mode, the positives, the hardest-contrastive loss on padded
    descriptors. ``pairs_in_loss``: a fault, the loss over the rows of the
    batch's first pairs alone."""
    raw, feats = [], []
    for s in sides:
        pyr = ref_vox.pyramid(s.coords, 4, m["conv1_kernel_size"])
        f = ref_model.descriptors(P, pyr, s.images, m, prec, train=True)
        raw.append(f)
        feats.append(torch.cat([f, f.new_zeros((s.n_pad - len(f), f.shape[1]))]))
    with torch.no_grad():
        pairs, ok = positives(sides[0], sides[1], T_gt, c["radius"])
    rows = [len(s.coords) if pairs_in_loss is None
            else int((s.coords[:, 0] < pairs_in_loss).sum()) for s in sides]
    valid = [torch.arange(s.n_pad, device=T_gt.device) < n for s, n in zip(sides, rows)]
    ok = ok & valid[0]
    pos, neg = hardest_contrastive(feats[0], valid[0], feats[1], valid[1], pairs, ok, draws,
                                   num_pos=c["num_pos"], num_hn=c["num_hn"],
                                   pos_thresh=c["pos_thresh"], neg_thresh=c["neg_thresh"])
    return pos + c["neg_weight"] * neg, pos, raw


def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             bufs: Dict[str, torch.Tensor], lr: float, momentum: float,
             weight_decay: float) -> None:
    """In place: d = g + wd p; buf = d at the first step, else m buf + d;
    p -= lr buf."""
    with torch.no_grad():
        for k, p in params.items():
            d = grads[k] + weight_decay * p
            bufs[k] = d.clone() if k not in bufs else momentum * bufs[k] + d
            p -= lr * bufs[k]
