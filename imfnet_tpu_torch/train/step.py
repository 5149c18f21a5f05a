"""The training step over padded pair batches (``imfnet_tpu.train.step``):
per-config pyramid construction, two model forwards in training mode (one
per fragment side), the positive search on the device, a metric-learning
loss, backward and the optimizer update. Equivalent of the per-iteration
body of `HardestContrastiveLossTrainer._train_epoch`
(`lib/trainer.py:495-569`).

Where the JAX package returns new parameter and statistics trees, the port
updates the module's parameters, buffers and the optimizer in place. A step
reads nothing back to the host: metrics are 0-d tensors.

``make_train_step`` is the plain step, as the JAX ``make_train_step`` is
the un-jitted one; ``make_graphed_train_step`` is the step as the JAX
trainer compiles it (``jax.jit``, ``imfnet_tpu/train/trainer.py:120``): on
the card one CUDA graph per batch signature (``utils.graphs.jit``) holds
the forwards, the loss, the backward and the optimizer's update.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.match.nn import nn_auto
from imfnet_tpu_torch.parallel.mesh import Mesh, float_buffers, mean_over_ranks
from imfnet_tpu_torch.sparse.coords import SparseVoxels, row_mask
from imfnet_tpu_torch.sparse.grid import GRID_MAP_IMPLS, GridSpec, build_pyramid_grid
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid
from imfnet_tpu_torch.train.losses import (contrastive_loss, draw_shapes, draws_for,
                                           hardest_contrastive_loss, hardest_triplet_loss,
                                           triplet_loss)
from imfnet_tpu_torch.train.state import TrainState
from imfnet_tpu_torch.utils import timer
from imfnet_tpu_torch.utils.graphs import jit

MAP_IMPLS = ("search",) + GRID_MAP_IMPLS


LOSS_FNS = {
    "HardestContrastiveLossTrainer": "hardest_contrastive",
    "ContrastiveLossTrainer": "contrastive",
    "TripletLossTrainer": "triplet",
    "HardestTripletLossTrainer": "hardest_triplet",
}


class PairBatch(NamedTuple):
    """One padded batch of fragment pairs, concatenated per side
    (``data.collate.collate_pairs`` makes it). ``pipeline.PairBatch`` is a
    different thing: one pair's raw points before voxelization."""

    coords0: torch.Tensor    # int32[N,4] key-sorted, batch column = pair index
    feats0: torch.Tensor     # [N,1] occupancy
    n0: torch.Tensor         # int32[]
    image0: torch.Tensor     # [B,H,W,3]
    coords1: torch.Tensor
    feats1: torch.Tensor
    n1: torch.Tensor
    image1: torch.Tensor
    pairs: Optional[torch.Tensor]       # int[P,2] positives (rows of the sides), or None
    pair_valid: Optional[torch.Tensor]  # bool[P]
    xyz0: torch.Tensor       # [N,3] positions of the voxel representatives
    xyz1: torch.Tensor
    T_gt: torch.Tensor       # [B,4,4]
    # positive-search radius per pair; 0 → the config's default
    search_radius: Optional[torch.Tensor] = None   # f32[B]


def level_capacities(
    n_pad: int, divisors: Tuple[int, ...] = (1, 2, 4, 8)
) -> Tuple[int, ...]:
    """Static per-level row capacities: level i holds ``n_pad // divisor[i]``
    rows (at least 256)."""
    return tuple(max(n_pad // d, 256) for d in divisors)


def make_pyramid_fn(config: Config, n_pad: int, num_batches: int = 2,
                    extent: Tuple[int, int, int] | None = None,
                    map_impl: str = "search", dim: int = 3):
    """fn(coords, num_valid) → CoordinatePyramid at this config's level
    capacities, for coordinates of dimension ``dim`` (3, or 6: the search
    builder alone).

    ``map_impl`` picks the builder; all give the same tables for
    in-extent inputs:
    - "search": sort + ``torch.searchsorted`` (``kernel_map.build_pyramid``),
      which needs no extent;
    - a grid builder of ``grid.GRID_MAP_IMPLS`` ("banded", the compact word
      tables through kernel D, which "auto" resolves to; "packed", "ywide",
      "transpose", plain PyTorch over dense tables): ``grid.build_pyramid_grid``
      in the static extent ``extent`` (default ``config.grid_extent``) for
      ``num_batches`` batches, as the JAX package's ``use_grid``/``extent``
      do. The pyramid has one level per entry
    of ``config.level_capacity_divisors`` (4 by default; SimpleNet3 needs
    5), where the JAX package always builds 4."""
    if map_impl not in MAP_IMPLS:
        raise ValueError(f"make_pyramid_fn: map_impl must be one of {MAP_IMPLS}, "
                         f"got {map_impl!r}")
    if dim not in (3, 6):
        raise ValueError(f"make_pyramid_fn: dim must be 3 or 6, got {dim}")
    if dim == 6 and map_impl != "search":
        raise ValueError(f"make_pyramid_fn: the packed-grid builders are 3-D; a 6-D "
                         f"pyramid takes map_impl='search', not {map_impl!r}")
    caps = level_capacities(n_pad, tuple(config.level_capacity_divisors))
    if map_impl == "search":
        def fn(coords, n):
            return build_pyramid(coords, n, num_levels=len(caps),
                                 conv1_kernel_size=config.conv1_kernel_size,
                                 level_capacity=caps)
        return fn

    spec = GridSpec(extent=tuple(extent if extent is not None else config.grid_extent),
                    num_batches=num_batches)

    def fn(coords, n):
        return build_pyramid_grid(coords, n, spec=spec, num_levels=len(caps),
                                  conv1_kernel_size=config.conv1_kernel_size,
                                  level_capacity=caps, map_impl=map_impl)

    return fn


def default_map_impl(config: Config) -> str:
    """The ``map_impl`` the config asks for: "banded" (the grid pyramid,
    kernel D) with ``config.use_grid_maps``, else "search"."""
    return "banded" if config.use_grid_maps else "search"


def forward_pair(model, batch: PairBatch, *, train: bool, config: Config,
                 map_impl: Optional[str] = None):
    """(f0, f1): the model on both sides, in ``train()`` or ``eval()`` mode.
    In training side 1 runs on the running statistics side 0 has just
    updated, as the reference updates them side by side
    (`lib/trainer.py:521-527`). ``map_impl`` picks how the pyramid is built
    (``make_pyramid_fn``); None follows ``config.use_grid_maps``, and the
    grid pyramid works in ``config.grid_extent`` for the batch's pairs, so
    its batches come from a ``collate_pairs`` that was given that extent."""
    if map_impl is None:
        map_impl = default_map_impl(config)
    num_batches = batch.image0.shape[0]
    pyramid_fn = make_pyramid_fn(config, batch.coords0.shape[0], num_batches,
                                 map_impl=map_impl)
    model.train(train)
    feats = []
    for coords, f, n, image in ((batch.coords0, batch.feats0, batch.n0, batch.image0),
                                (batch.coords1, batch.feats1, batch.n1, batch.image1)):
        with torch.no_grad():
            pyr = pyramid_fn(coords, n)
        feats.append(model(SparseVoxels(coords, f, n), pyr, image))
    return feats[0], feats[1]


def compute_correspondences(batch: PairBatch, search_radius
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positive-pair search on the device (the reference's per-sample KD-tree
    radius query, `util/pointcloud.py:56-69`): for every valid voxel of side
    0, its nearest side-1 voxel of the same pair after the ground-truth
    transform, kept if within ``search_radius`` (a scalar or one radius per
    pair of the batch). Returns (pairs int32[N,2], ok bool[N]).

    One nearest-neighbour call per pair of the batch, with the other pairs'
    references masked out and the results selected by the query's pair
    index. ``imfnet_tpu.train.step.compute_correspondences`` instead keeps
    the pairs apart in one call by adding ``pair · 1e5`` to every
    coordinate; in f32 that leaves |x|² ≈ 3e10 an ulp of 2048 against a
    radius² of 1.4e-3, so the search of every pair but the first is noise
    there. The port's search is exact for every pair."""
    n0, n1 = batch.coords0.shape[0], batch.coords1.shape[0]
    v0 = row_mask(n0, batch.n0)
    v1 = row_mask(n1, batch.n1)
    zero = torch.zeros_like(batch.coords0[:, 0])
    b0 = torch.where(v0, batch.coords0[:, 0], zero)
    b1 = torch.where(v1, batch.coords1[:, 0], zero)
    nb = batch.T_gt.shape[0]
    bc = b0.clamp_max(nb - 1)
    x0 = None
    for i in range(nb):
        Ti = batch.T_gt[i]
        xi = batch.xyz0 @ Ti[:3, :3].T + Ti[:3, 3]
        x0 = xi if x0 is None else torch.where((bc == i)[:, None], xi, x0)
    idx = d2 = None
    for i in range(nb):
        idx_i, d2_i = nn_auto(x0, batch.xyz1, v1 & (b1 == i))
        idx = idx_i if idx is None else torch.where(bc == i, idx_i, idx)
        d2 = d2_i if d2 is None else torch.where(bc == i, d2_i, d2)
    r = torch.as_tensor(search_radius, dtype=torch.float32, device=x0.device)
    r0 = r if r.dim() == 0 else r[b0.long().clamp_max(r.shape[0] - 1)]
    ok = v0 & (d2 <= r0 * r0)
    rows = torch.arange(n0, dtype=torch.int32, device=x0.device)
    return torch.stack([rows, idx.to(torch.int32)], dim=1), ok


def make_loss_fn(model, config: Config, map_impl: Optional[str] = None):
    """loss_fn(batch, generator=None, draws=None) → (loss, metrics): both
    forwards in training mode (the running statistics move) and the
    config's loss. ``draws`` replaces the loss's random draws
    (``train.losses``); ``map_impl`` goes to ``forward_pair``."""
    loss_kind = LOSS_FNS[config.trainer]
    bs = config.batch_size

    def loss_fn(batch: PairBatch, generator: Optional[torch.Generator] = None,
                draws: Optional[Sequence[torch.Tensor]] = None):
        f0, f1 = forward_pair(model, batch, train=True, config=config,
                              map_impl=map_impl)
        valid0 = row_mask(f0.shape[0], batch.n0)
        valid1 = row_mask(f1.shape[0], batch.n1)
        if batch.pairs is None:
            # matching_search_voxel_size = voxel * multiplier
            # (`lib/data_loaders.py:122`); a pair's own radius, where the
            # batch carries one, holds the random-scale factor
            radius = config.voxel_size * config.positive_pair_search_voxel_size_multiplier
            if batch.search_radius is not None:
                radius = torch.where(batch.search_radius > 0, batch.search_radius,
                                     torch.full_like(batch.search_radius, radius))
            with torch.no_grad():
                pairs, pair_valid = compute_correspondences(batch, radius)
        else:
            pairs, pair_valid = batch.pairs, batch.pair_valid
        args = (f0, valid0, f1, valid1, pairs, pair_valid)
        rand = dict(generator=generator, draws=draws)
        if loss_kind in ("hardest_contrastive", "contrastive"):
            if loss_kind == "hardest_contrastive":
                pos, neg = hardest_contrastive_loss(
                    *args, num_pos=config.num_pos_per_batch * bs,
                    num_hn_samples=config.num_hn_samples_per_batch * bs,
                    pos_thresh=config.pos_thresh, neg_thresh=config.neg_thresh, **rand)
            else:
                pos, neg = contrastive_loss(*args, neg_thresh=config.neg_thresh, **rand)
            loss = pos + config.neg_weight * neg
            metrics = {"loss": loss, "pos_loss": pos, "neg_loss": neg}
        else:
            if loss_kind == "triplet":
                loss, pd, nd = triplet_loss(
                    *args, num_pos=config.triplet_num_pos * bs,
                    num_rand_triplet=config.triplet_num_rand * bs,
                    neg_thresh=config.neg_thresh, **rand)
            else:
                loss, pd, nd = hardest_triplet_loss(
                    *args, num_pos=config.triplet_num_pos * bs,
                    num_hn_samples=config.triplet_num_hn * bs,
                    num_rand_triplet=config.triplet_num_rand * bs,
                    neg_thresh=config.neg_thresh, **rand)
            metrics = {"loss": loss, "pos_dist": pd, "neg_dist": nd}
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def _apply(state: TrainState) -> None:
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1


def mean_step_over_ranks(model: torch.nn.Module, metrics: Dict[str, torch.Tensor],
                         mesh: Mesh) -> Dict[str, torch.Tensor]:
    """What ``jax.lax.pmean`` averages over the data-parallel axis, after a
    rank's backward: the gradients (one all-reduce of them all), the float
    buffers (the running statistics each rank's forward moved from the same
    old values) and the metrics, which are returned."""
    mean_over_ranks([p.grad for p in model.parameters() if p.grad is not None], mesh)
    mean_over_ranks(float_buffers(model), mesh)
    keys = sorted(metrics)
    stacked = mean_over_ranks([torch.stack([metrics[k].float() for k in keys])], mesh)[0]
    return dict(zip(keys, stacked.unbind()))


def make_train_step(config: Config, map_impl: Optional[str] = None,
                    mesh: Optional[Mesh] = None):
    """train_step(state, batch, generator=None, draws=None) → (state,
    metrics): loss, backward, one optimizer step, one step of the learning
    rate schedule. ``state`` (``train.state.create_train_state``) is updated
    in place and returned. ``map_impl`` goes to ``forward_pair``.

    With a ``mesh`` (``parallel.mesh.make_mesh``; the JAX package's
    ``axis_name``) each rank takes its own batch and the step averages the
    gradients, running statistics and metrics over the ranks before the
    optimizer step (``mean_step_over_ranks``); without one it is the
    one-device step."""

    def train_step(state: TrainState, batch: PairBatch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, metrics = make_loss_fn(state.model, config, map_impl)(batch, generator, draws)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            metrics = mean_step_over_ranks(state.model, metrics, mesh)
        _apply(state)
        return state, metrics

    return train_step


def loss_draws(config: Config, batch: PairBatch,
               generator: Optional[torch.Generator] = None) -> list:
    """The uniform draws the config's loss would make from ``generator`` on
    this batch, made now in the same order and shapes
    (``losses.draw_shapes``): passed as ``draws``, they give the step that
    draws itself, and leave the generator where it would."""
    n0, n1 = batch.coords0.shape[0], batch.coords1.shape[0]
    n_pairs = n0 if batch.pairs is None else batch.pairs.shape[0]
    return draws_for(draw_shapes(LOSS_FNS[config.trainer], n0, n1, n_pairs),
                     generator, batch.coords0.device)


def make_graphed_train_step(config: Config, map_impl: Optional[str] = None):
    """train_step(state, batch, generator=None, draws=None) → (state,
    metrics): ``make_train_step``'s one-device step, structured as the JAX
    trainer's jitted step. Outside the graph: the loss's draws
    (``loss_draws``, unless ``draws`` are given), the schedule's step (which
    fills the tensor learning rate, ``train.state.make_optimizer``) and
    ``state.step``. Inside: the forwards, the loss, the backward and the
    optimizer's update. On the card that part is one CUDA graph per batch
    signature (``utils.graphs.jit``; the first call of each runs eagerly,
    the second is captured), so the state's optimizer must be capturable;
    on the CPU it runs eagerly. Given the same draws the result equals
    ``make_train_step``'s; the metrics are the graph's outputs, which the
    next step overwrites (clone what is kept). ``train_step.graphed`` is the
    ``utils.graphs.Graphed`` (its ``replays``, its graphs' launches). The
    graph's stages (``utils.timer.stage``) are ``step.forward`` (the
    forwards and the loss), ``step.backward`` and ``step.sgd``."""

    def body(state: TrainState, batch: PairBatch, draws: Sequence[torch.Tensor]):
        timer.stage("step.forward")
        loss, metrics = make_loss_fn(state.model, config, map_impl)(batch, None, draws)
        timer.stage("step.backward")
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        timer.stage("step.sgd")
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return metrics

    graphed = jit(body)

    def train_step(state: TrainState, batch: PairBatch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if draws is None:
            draws = loss_draws(config, batch, generator)
        run = graphed if batch.coords0.device.type == "cuda" else body
        metrics = run(state, batch, list(draws))
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return state, metrics

    train_step.graphed = graphed
    return train_step


def make_accum_steps(config: Config, map_impl: Optional[str] = None):
    """Gradient accumulation over ``config.iter_size`` micro-batches, the
    reference's only scaling knob (`lib/trainer.py:252-307`): the loss is
    divided by iter_size, backward accumulates, one optimizer step per
    group; the running statistics move with every micro-batch.

    Returns (grad_step, apply_step):
      grad_step(state, batch, generator=None, draws=None) → metrics — once
          per micro-batch; the gradients add up in ``param.grad``, which the
          group's first call must find empty (a new state, or after
          apply_step)
      apply_step(state) → state — one optimizer step on the sum, which is
          the group's mean gradient
    ``map_impl`` goes to ``forward_pair``.
    """
    scale = 1.0 / float(max(config.iter_size, 1))

    def grad_step(state: TrainState, batch: PairBatch,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Sequence[torch.Tensor]] = None):
        loss, metrics = make_loss_fn(state.model, config, map_impl)(batch, generator, draws)
        (loss * scale).backward()
        return metrics

    def apply_step(state: TrainState) -> TrainState:
        _apply(state)
        return state

    return grad_step, apply_step
