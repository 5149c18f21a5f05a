"""Metric-learning losses on the device with masked static shapes
(``imfnet_tpu.train.losses``).

Reference semantics: `lib/trainer.py`
- contrastive_loss              — ContrastiveLossTrainer (:236-329)
- hardest_contrastive_loss      — HardestContrastiveLossTrainer (:440-492)
- triplet_loss                  — TripletLossTrainer (:574-621)
- hardest_triplet_loss          — HardestTripletLossTrainer (:702-775)

Positive-pair membership (the reference's numpy `_hash`/`np.isin`,
`util/misc.py:6-18`) is a binary search in a sorted int64 key table
``i << 32 | j`` (the JAX package packs ``i << 16 | j`` into a uint32 and so
needs rows below 2^16; the membership is the same). Sampling without
replacement is the uniform-score top-k over validity-masked candidates.

Random draws come from ``generator``; ``draws`` replaces them with given
tensors, in the order the JAX function splits its key, so that a test can
feed both packages the same numbers: uniform scores ``f32[n]`` for a
sampler over ``n`` candidates; for ``contrastive_loss`` integer rows, or the
uniforms its rows are made from. ``draw_shapes`` gives the shapes of a
loss's uniform draws in the order the loss makes them from its generator,
so that a caller can draw them outside a CUDA graph and pass them in
(``draws_for``), with the generator left as the loss would leave it.
Nothing here reads a value back to the host.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

INVALID_PAIR_KEY = torch.iinfo(torch.int64).max


def _sample_without_replacement(valid: torch.Tensor, k: int,
                                generator: Optional[torch.Generator] = None,
                                u: Optional[torch.Tensor] = None):
    """k distinct indices of True entries, uniform: (idx long[k], ok bool[k]).
    With fewer than k True entries the tail has ok False."""
    if u is None:
        u = torch.rand(valid.shape, generator=generator, device=valid.device)
    scores = torch.where(valid, u, torch.full_like(u, -1.0))
    top, idx = torch.topk(scores, k)
    return idx, top >= 0.0


def _draw(draws: Optional[Sequence[torch.Tensor]], i: int) -> Optional[torch.Tensor]:
    return None if draws is None else draws[i]


def draw_shapes(loss_kind: str, n0: int, n1: int, n_pairs: int,
                num_neg: int = 0) -> Tuple[Tuple[int, ...], ...]:
    """The shapes of the uniform draws the loss ``loss_kind``
    ("hardest_contrastive", "contrastive", "triplet", "hardest_triplet")
    makes from its generator, in order, for ``n0`` and ``n1`` rows a side and
    ``n_pairs`` candidate positives (``num_neg`` as ``contrastive_loss``
    takes it)."""
    if loss_kind == "hardest_contrastive":
        return (n0,), (n1,), (n_pairs,)
    if loss_kind == "contrastive":
        k = num_neg or 2 * n_pairs
        return (k,), (k,)
    if loss_kind == "triplet":
        return (n_pairs,), (n_pairs,), (n1,)
    if loss_kind == "hardest_triplet":
        return (n0,), (n1,), (n_pairs,), (n_pairs,), (n1,)
    raise ValueError(f"draw_shapes: unknown loss {loss_kind!r}")


def draws_for(shapes: Sequence[Tuple[int, ...]], generator: Optional[torch.Generator],
              device) -> list:
    """Uniform draws of the given shapes from ``generator``, one after
    another: the numbers the loss would draw itself."""
    return [torch.rand(s, generator=generator, device=device) for s in shapes]


def _pair_keys(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """int64 key of an (i, j) index pair."""
    return (i.to(torch.int64) << 32) | j.to(torch.int64)


def _make_pair_set(pairs: torch.Tensor, pair_valid: torch.Tensor) -> torch.Tensor:
    """Sorted key table of the positive pairs (invalid → max key, last)."""
    keys = _pair_keys(pairs[:, 0], pairs[:, 1])
    keys = torch.where(pair_valid, keys, torch.full_like(keys, INVALID_PAIR_KEY))
    return torch.sort(keys).values


def _in_pair_set(table: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    q = _pair_keys(i, j)
    pos = torch.searchsorted(table, q).clamp_max(table.shape[0] - 1)
    return table[pos] == q


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    w = m.float()
    return (x * w).sum() / w.sum().clamp_min(1.0)


def _pdist_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt distances, `lib/metrics.py:22-25` (adds 1e-7 under the root)."""
    a, b = a.float(), b.float()
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    return torch.sqrt(sq.clamp_min(0.0) + 1e-7)


def _row_dist(a: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.sqrt(((a - b) ** 2).sum(1) + eps)


def _masked_min(d: torch.Tensor, ok: torch.Tensor):
    d = torch.where(ok[None, :], d, torch.full_like(d, float("inf")))
    return d.min(dim=1)


def hardest_contrastive_loss(
    f0: torch.Tensor, valid0: torch.Tensor,
    f1: torch.Tensor, valid1: torch.Tensor,
    pairs: torch.Tensor,       # int[P,2] positive pairs (rows into f0/f1)
    pair_valid: torch.Tensor,  # bool[P]
    *,
    num_pos: int = 1024,
    num_hn_samples: int = 256,
    pos_thresh: float = 0.1,
    neg_thresh: float = 1.4,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,   # u[N0], u[N1], u[P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_loss, neg_loss) of `contrastive_hardest_negative_loss`
    (`lib/trainer.py:440-492`)."""
    sel0, sel0_ok = _sample_without_replacement(valid0, num_hn_samples, generator, _draw(draws, 0))
    sel1, sel1_ok = _sample_without_replacement(valid1, num_hn_samples, generator, _draw(draws, 1))
    psel, psel_ok = _sample_without_replacement(pair_valid, num_pos, generator, _draw(draws, 2))

    pi = pairs[:, 0].long()[psel]
    pj = pairs[:, 1].long()[psel]
    pos_f0, pos_f1 = f0[pi], f1[pj]
    d01_min, d01_arg = _masked_min(_pdist_l2(pos_f0, f1[sel1]), sel1_ok)
    d10_min, d10_arg = _masked_min(_pdist_l2(pos_f1, f0[sel0]), sel0_ok)

    table = _make_pair_set(pairs, pair_valid)
    mask0 = psel_ok & ~_in_pair_set(table, pi, sel1[d01_arg])
    mask1 = psel_ok & ~_in_pair_set(table, sel0[d10_arg], pj)

    pos_sq = ((pos_f0 - pos_f1) ** 2).sum(dim=1)
    pos_loss = _masked_mean(torch.relu(pos_sq - pos_thresh), psel_ok)
    neg_loss0 = _masked_mean(torch.relu(neg_thresh - d01_min) ** 2, mask0)
    neg_loss1 = _masked_mean(torch.relu(neg_thresh - d10_min) ** 2, mask1)
    return pos_loss, (neg_loss0 + neg_loss1) / 2.0


def contrastive_loss(
    f0: torch.Tensor, valid0: torch.Tensor,
    f1: torch.Tensor, valid1: torch.Tensor,
    pairs: torch.Tensor,
    pair_valid: torch.Tensor,
    *,
    num_neg: int = 0,
    neg_thresh: float = 1.4,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,   # rows int[num_neg] of f0, of f1, or u[num_neg] ×2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random-negative contrastive loss (`lib/trainer.py:236-305`): the mean
    squared distance over all valid pairs; hinge² on the sqrt distance of
    random (i, j) that are not positives (default ``num_neg`` = 2 P). Valid
    rows lie in front of f0/f1 (key-sorted layout), so a random row below
    the valid count is a random valid row."""
    if num_neg == 0:
        num_neg = 2 * pairs.shape[0]
    if draws is not None and not draws[0].is_floating_point():
        ri, rj = draws[0].long(), draws[1].long()
    else:
        def rows(valid, u):
            n = valid.sum().clamp_min(1)
            if u is None:
                u = torch.rand((num_neg,), generator=generator, device=valid.device)
            return (u * n).long().clamp_max(n - 1)
        ri, rj = rows(valid0, _draw(draws, 0)), rows(valid1, _draw(draws, 1))
    table = _make_pair_set(pairs, pair_valid)
    neg_ok = ~_in_pair_set(table, ri, rj)

    pos_f0 = f0[pairs[:, 0].long()]
    pos_f1 = f1[pairs[:, 1].long()]
    pos_loss = _masked_mean(((pos_f0 - pos_f1) ** 2).sum(1), pair_valid)
    neg_d = _row_dist(f0[ri], f1[rj], 1e-4)
    neg_loss = _masked_mean(torch.relu(neg_thresh - neg_d) ** 2, neg_ok)
    return pos_loss, neg_loss


def _random_triplets(f0, f1, valid1, pairs, pair_valid, table, num_rand_triplet,
                     generator, u_pairs, u_negs):
    """(anchor-positive distance, anchor-negative distance, ok) of random
    triplets: a random positive pair and a random row of f1 that is not the
    anchor's positive."""
    rsel, rsel_ok = _sample_without_replacement(pair_valid, num_rand_triplet, generator, u_pairs)
    negs, negs_ok = _sample_without_replacement(valid1, num_rand_triplet, generator, u_negs)
    ai = pairs[:, 0].long()[rsel]
    aj = pairs[:, 1].long()[rsel]
    tri_ok = rsel_ok & negs_ok & ~_in_pair_set(table, ai, negs)
    return _row_dist(f0[ai], f1[aj], 1e-7), _row_dist(f0[ai], f1[negs], 1e-7), tri_ok


def triplet_loss(
    f0: torch.Tensor, valid0: torch.Tensor,
    f1: torch.Tensor, valid1: torch.Tensor,
    pairs: torch.Tensor,
    pair_valid: torch.Tensor,
    *,
    num_pos: int = 1024,
    num_rand_triplet: int = 1024,
    neg_thresh: float = 1.4,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,   # u[P], u[P], u[N1]
):
    """Random-triplet loss (`lib/trainer.py:574-621`):
    (loss, mean_pos_dist, mean_neg_dist)."""
    psel, psel_ok = _sample_without_replacement(pair_valid, num_pos, generator, _draw(draws, 0))
    pos_dist = _row_dist(f0[pairs[:, 0].long()[psel]], f1[pairs[:, 1].long()[psel]], 1e-7)
    table = _make_pair_set(pairs, pair_valid)
    rp, rn, tri_ok = _random_triplets(f0, f1, valid1, pairs, pair_valid, table,
                                      num_rand_triplet, generator,
                                      _draw(draws, 1), _draw(draws, 2))
    loss = _masked_mean(torch.relu(rp + neg_thresh - rn), tri_ok)
    return loss, _masked_mean(pos_dist, psel_ok), _masked_mean(rn, tri_ok)


def hardest_triplet_loss(
    f0: torch.Tensor, valid0: torch.Tensor,
    f1: torch.Tensor, valid1: torch.Tensor,
    pairs: torch.Tensor,
    pair_valid: torch.Tensor,
    *,
    num_pos: int = 1024,
    num_hn_samples: int = 512,
    num_rand_triplet: int = 1024,
    neg_thresh: float = 1.4,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,   # u[N0], u[N1], u[P], u[P], u[N1]
):
    """Hardest-in-batch triplet loss (`lib/trainer.py:702-775`): the hinge
    over random triplets and both directions of mined hardest negatives."""
    sel0, sel0_ok = _sample_without_replacement(valid0, num_hn_samples, generator, _draw(draws, 0))
    sel1, sel1_ok = _sample_without_replacement(valid1, num_hn_samples, generator, _draw(draws, 1))
    psel, psel_ok = _sample_without_replacement(pair_valid, num_pos, generator, _draw(draws, 2))

    pi = pairs[:, 0].long()[psel]
    pj = pairs[:, 1].long()[psel]
    pos_f0, pos_f1 = f0[pi], f1[pj]
    d01_min, d01_arg = _masked_min(_pdist_l2(pos_f0, f1[sel1]), sel1_ok)
    d10_min, d10_arg = _masked_min(_pdist_l2(pos_f1, f0[sel0]), sel0_ok)

    table = _make_pair_set(pairs, pair_valid)
    mask0 = psel_ok & ~_in_pair_set(table, pi, sel1[d01_arg])
    mask1 = psel_ok & ~_in_pair_set(table, sel0[d10_arg], pj)
    pos_dist = _row_dist(pos_f0, pos_f1, 1e-7)

    rp, rn, tri_ok = _random_triplets(f0, f1, valid1, pairs, pair_valid, table,
                                      num_rand_triplet, generator,
                                      _draw(draws, 3), _draw(draws, 4))
    # masked mean over the concatenated hinge terms (`lib/trainer.py:768-773`)
    terms = torch.cat([torch.relu(rp + neg_thresh - rn),
                       torch.relu(pos_dist + neg_thresh - d01_min),
                       torch.relu(pos_dist + neg_thresh - d10_min)])
    loss = _masked_mean(terms, torch.cat([tri_ok, mask0, mask1]))
    neg_d = (_masked_mean(d01_min, psel_ok) + _masked_mean(d10_min, psel_ok)) / 2
    return loss, _masked_mean(pos_dist, psel_ok), neg_d
