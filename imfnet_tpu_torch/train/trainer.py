"""High-level training orchestration (``imfnet_tpu.train.trainer``).

The `AlignmentTrainer` equivalent (`lib/trainer.py:28-198`): builds the model
from config, runs epochs, validates every `val_epoch_freq`, tracks the best
validation metric (max for feat_match_ratio/success, min for rre/rte,
`lib/trainer.py:148-181`), writes `config.json` into the run dir, saves
per-epoch + best checkpoints with the metric value in the name, and resumes
full state. One Trainer class covers all four loss flavours (the loss is
selected inside the step via config.trainer).

The loaders yield batches of host tensors; the trainer moves each to a
card through a ring of page-locked staging slabs reused across batches
(``BatchStager``). Random draws: one ``torch.Generator`` on the
device, seeded from ``config.seed``, feeds every training step; the
validation step of batch ``i`` gets a generator seeded with ``i``, so a
validation epoch does not depend on how many steps were trained before it.

Data parallelism (``config.data_parallel`` > 1) runs one Trainer a rank,
each given the rank's ``parallel.mesh.Mesh`` (``cli train --num-devices``
starts them): the train loader is sharded over the ranks, each step takes
one batch a rank and averages over them (``make_train_step(mesh=)``), rank
``r`` draws from a generator seeded with ``parallel.dp.rank_seed(seed,
r)``, every rank validates on the whole split and gates on rank 0's result,
and rank 0 alone writes ``config.json``, metrics and checkpoints, which keep
every rank's random streams.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.parallel.dp import rank_generator, replicate
from imfnet_tpu_torch.parallel.mesh import Mesh, all_gather
from imfnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from imfnet_tpu_torch.train.state import TrainState, create_train_state
from imfnet_tpu_torch.train.step import PairBatch, make_accum_steps, make_train_step
from imfnet_tpu_torch.train.validate import make_val_step
from imfnet_tpu_torch.utils.device import resolve_device
from imfnet_tpu_torch.utils.timer import AverageMeter, Timer


class MetricsWriter:
    """JSONL scalar log (stands in for tensorboardX, `lib/trainer.py:101`).
    ``enabled=False`` (every rank but 0) writes nothing."""

    def __init__(self, out_dir: str, enabled: bool = True):
        self._f = None
        if enabled:
            os.makedirs(out_dir, exist_ok=True)
            self._f = open(os.path.join(out_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._f is None:
            return
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()


def build_model_from_config(config: Config, compute_dtype=None,
                            eval_fast: bool = False) -> torch.nn.Module:
    """The config's model with seeded random weights (``config.seed``).
    eval_fast enables inference-only fast paths (occupancy conv1); the
    parameters and buffers are unchanged, so a ``state_dict`` loads either
    way."""
    dt = compute_dtype or getattr(torch, config.compute_dtype)
    kw = dict(
        in_channels=config.in_channels,
        out_channels=config.model_n_out,
        conv1_kernel_size=config.conv1_kernel_size,
        normalize_feature=config.normalize_feature,
        bn_momentum=config.bn_momentum,
        compute_dtype=dt,
    )
    if eval_fast and config.model.startswith("ResUNet") and config.in_channels == 1:
        kw["conv1_occupancy"] = True
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        return load_model(config.model)(**kw)


STAGING_ALIGN = 256   # bytes: each field of a staged slab starts on this


def staging_layout(batch) -> Tuple[List[Tuple[int, torch.Tensor, int]], List[int], int]:
    """How a batch packs into one byte slab: (field index, tensor, bytes) of
    each field on the host, each field's offset (a multiple of
    ``STAGING_ALIGN``), and the slab's bytes."""
    fields = [(i, t, t.numel() * t.element_size()) for i, t in enumerate(batch)
              if t is not None and t.device.type == "cpu"]
    offsets, total = [], 0
    for _, _, nbytes in fields:
        offsets.append(total)
        total += -(-nbytes // STAGING_ALIGN) * STAGING_ALIGN
    return fields, offsets, total


def pack_fields(slab: torch.Tensor, fields, offsets) -> None:
    """Copies each host field's bytes into its place of the uint8 ``slab``
    (a CPU tensor). One plain memcpy a field on this thread: a loader's
    worker process keeps the host's cores busy, and a copy split over
    torch's thread pool then waits on its barriers."""
    dst = slab.numpy()
    for (_, t, nbytes), off in zip(fields, offsets):
        np.copyto(dst[off:off + nbytes], t.reshape(-1).view(torch.uint8).numpy())


def unpack_fields(batch, slab: torch.Tensor, fields, offsets) -> PairBatch:
    """The batch with each packed field a view into ``slab`` and every
    other field as it was moved to the slab's device."""
    out = [t if t is None or t.device.type == "cpu" else t.to(slab.device) for t in batch]
    for (i, t, nbytes), off in zip(fields, offsets):
        out[i] = slab[off:off + nbytes].view(t.dtype).view(t.shape)
    return PairBatch(*out)


STAGING_SLOTS = 2     # slabs a card's ring holds: one being packed, one in flight


class BatchStager:
    """Moves batches of host tensors to one card through a ring of
    page-locked staging slabs, reused across batches.

    A batch's fields are packed into its slot's slab (``staging_layout``,
    one host copy each), the slab goes to one new device slab in one
    ``copy_(non_blocking=True)``, and the device batch is made of views into
    it. A slot is rewritten only after the CUDA event recorded after its
    last copy has completed; a batch that outgrows its slot gets a new,
    larger one. Fields already on the device pass through.

    Two slots: the slot a move rewrites was last copied two moves back.
    The trainer and the evaluations read a result of each step back to the
    host (a loss, a transform) before their next move, so that copy has
    ended and the wait costs nothing; micro-steps of an accumulation, which
    read nothing back, wait at most for the step before the last."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"BatchStager: a CUDA device, not {self.device}")
        self._slots: List[Tuple[Optional[torch.Tensor], Optional[torch.cuda.Event]]] = \
            [(None, None)] * STAGING_SLOTS
        self._next = 0

    def __call__(self, batch: PairBatch) -> PairBatch:
        fields, offsets, total = staging_layout(batch)
        k = self._next
        self._next = (k + 1) % STAGING_SLOTS
        slab, done = self._slots[k]
        if done is not None:
            done.synchronize()      # the copy that last read this slot has ended
        if slab is None or slab.numel() < total:
            slab = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
        pack_fields(slab, fields, offsets)
        dev = torch.empty((total,), dtype=torch.uint8, device=self.device)
        dev.copy_(slab[:total], non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._slots[k] = (slab, event)
        return unpack_fields(batch, dev, fields, offsets)


_STAGERS: Dict[torch.device, BatchStager] = {}


def batch_to_device(batch: PairBatch, device: torch.device) -> PairBatch:
    """The batch's tensors on ``device``: towards a card through the card's
    staging ring (one ``BatchStager`` a card, made at its first move),
    without blocking the host; elsewhere ``t.to(device)``."""
    device = torch.device(device)
    if device.type != "cuda":
        return PairBatch(*(None if t is None else t.to(device) for t in batch))
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _STAGERS:
        _STAGERS[device] = BatchStager(device)
    return _STAGERS[device](batch)


def _close(it) -> None:
    """Ends a loader's iterator early, which releases its producer, or
    stops a loader's worker process; a plain iterable has nothing to
    close."""
    close = getattr(it, "close", None)
    if close is not None:
        close()


def _rng_state(rng: np.random.RandomState) -> Dict[str, Any]:
    """A ``RandomState``'s stream as tensors and numbers (``state.pt`` is
    loaded with ``weights_only``, which takes no numpy arrays)."""
    name, keys, pos, has_gauss, cached = rng.get_state()
    return dict(name=name, keys=torch.from_numpy(keys.astype(np.int64)), pos=int(pos),
                has_gauss=int(has_gauss), cached=float(cached))


def _set_rng_state(rng: np.random.RandomState, s: Dict[str, Any]) -> None:
    rng.set_state((s["name"], s["keys"].cpu().numpy().astype(np.uint32), s["pos"],
                   s["has_gauss"], s["cached"]))


def resolve_data_parallel(config: Config, batches: int, available: int) -> int:
    """The number of ranks ``config.data_parallel`` asks for, given the
    epoch's ``batches`` over all ranks and the ``available`` devices: 0 is
    every device, clamped so that each epoch takes at least one optimizer
    step (and 1 with ``iter_size`` > 1). Raises for more than are there,
    or an epoch that would take no step."""
    iters = max(config.iter_size, 1)
    n = config.data_parallel
    if n == 0:
        n = max(min(available, batches // iters), 1)
        if n > 1 and iters > 1:
            n = 1   # accumulation is not wired with data parallelism
    if n > available:
        raise ValueError(f"config.data_parallel={n} but only {available} devices are "
                         f"addressable")
    if batches // iters // n == 0:
        raise ValueError(f"loader yields {batches} batches per epoch but data_parallel={n} "
                         f"× iter_size={config.iter_size} consumes more; no optimizer step "
                         f"would run")
    return n


class Trainer:
    _MAX_METRICS = ("feat_match_ratio", "success")
    _MIN_METRICS = ("rre", "rte")

    def __init__(
        self,
        config: Config,
        data_loader: Iterable,
        val_data_loader: Optional[Iterable] = None,
        steps_per_epoch: Optional[int] = None,
        device=None,
        mesh: Optional[Mesh] = None,
    ):
        """``device`` defaults to the card and raises without one; pass
        ``device="cpu"`` for the plain PyTorch path. ``mesh`` makes this
        Trainer one rank of a data-parallel run on ``mesh.device``: a train
        loader that is not sharded yet is given this rank's shard."""
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.config = config
        self.data_loader = data_loader
        self.val_data_loader = val_data_loader
        self.mesh = mesh
        world = mesh.world_size if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        if world > 1 and getattr(data_loader, "shard", False) is None:
            data_loader.shard = (self.rank, world, 1)
        # one device a rank: without a mesh one is there
        self.n_devices = self._resolve_devices(steps_per_epoch, world)
        if self.n_devices > 1:
            if config.iter_size > 1:
                raise NotImplementedError(
                    "iter_size gradient accumulation is not wired together with data "
                    "parallelism; use data_parallel=1 or iter_size=1")
            if world != self.n_devices:
                raise ValueError(f"config.data_parallel resolves to {self.n_devices} ranks "
                                 f"but the mesh has {world}")
        self.is_main = self.rank == 0
        batches = steps_per_epoch or len(data_loader)
        self.model = build_model_from_config(config).to(self.device)
        # the schedule needs the optimizer steps per epoch (of this rank's
        # loader) before the optimizer exists
        self.steps_per_epoch = max(batches // max(config.iter_size, 1), 1)
        self.train_step = make_train_step(config, mesh=mesh)
        if config.iter_size > 1:
            self.grad_step, self.apply_step = make_accum_steps(config)
        self.val_step = make_val_step(self.model, config)

        self.best_val_metric = config.best_val_metric
        self.best_val = -np.inf if self.best_val_metric in self._MAX_METRICS else np.inf
        self.best_val_epoch = -1
        self.start_epoch = 1
        self.out_dir = config.out_dir
        if self.is_main:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(os.path.join(self.out_dir, "config.json"), "w") as f:
                f.write(config.to_json())
        self.writer = MetricsWriter(self.out_dir, enabled=self.is_main)
        self.state: Optional[TrainState] = None
        self.generator = rank_generator(config.seed, self.rank, self.device)
        # the last training epoch's timers and loss meter, for a caller that
        # reports them
        self.total_timer, self.data_timer, self.move_timer = Timer(), Timer(), Timer()
        self.loss_meter = AverageMeter()

    def _resolve_devices(self, steps_per_epoch: Optional[int], world: int) -> int:
        """``resolve_data_parallel`` over the epoch's batches on all ranks
        (this rank's loader holds 1/world of them) and the mesh's ranks."""
        batches = (steps_per_epoch or len(self.data_loader)) * world
        return resolve_data_parallel(self.config, batches, world)

    # -- state init ---------------------------------------------------------
    def init_state(self, example_batch: Optional[PairBatch] = None) -> TrainState:
        """The train state of the seeded model, or of ``config.resume``.
        ``example_batch`` is accepted for the JAX package's signature, where
        the parameters' shapes come from a traced forward; a module knows
        its own."""
        self.state = create_train_state(self.model, self.config, self.steps_per_epoch)
        if self.config.resume:
            self.state, meta = load_checkpoint(self.config.resume, self.state)
            # meta["epoch"] is the last epoch that was trained: go on after it
            self.start_epoch = meta["epoch"] + 1
            self.best_val = meta.get("best_val", self.best_val)
            self.best_val_epoch = meta.get("best_val_epoch", -1)
            self.best_val_metric = meta.get("best_val_metric", self.best_val_metric)
            self._restore_streams(meta["extra"])
            logging.info("resumed from %s; next epoch %d", self.config.resume,
                         self.start_epoch)
        if self.mesh is not None:
            replicate(self.mesh, self.model)
        return self.state

    def _host_streams(self):
        """(name, RandomState) of every host stream the loaders carry: the
        shuffle permutations and the datasets' augmentation draws."""
        for name, loader in (("train", self.data_loader), ("val", self.val_data_loader)):
            for attr, rng in (("shuffle", getattr(loader, "rng", None)),
                              ("augment", getattr(getattr(loader, "dataset", None),
                                                  "randg", None))):
                if isinstance(rng, np.random.RandomState):
                    yield f"{name}_{attr}", rng

    def _streams(self) -> Dict[str, Any]:
        """The random streams a resumed run needs to continue as the
        uninterrupted one would: the training generator and the loaders'.
        Under a mesh of several ranks, a collective: every rank's streams
        (``rank_streams``, in rank order) beside rank 0's."""
        out: Dict[str, Any] = {"generator": self.generator.get_state()}
        out.update((name, _rng_state(rng)) for name, rng in self._host_streams())
        if self.mesh is not None and self.mesh.world_size > 1:
            out["rank_streams"] = all_gather(self.mesh, dict(out))
        return out

    def _restore_streams(self, extra: Dict[str, Any]) -> None:
        ranks = extra.get("rank_streams")
        if ranks is not None:
            if self.mesh is None or len(ranks) != self.mesh.world_size:
                raise ValueError(f"the checkpoint holds the streams of {len(ranks)} ranks; "
                                 f"resume it on as many")
            extra = ranks[self.rank]
        if "generator" in extra:
            self.generator.set_state(extra["generator"].cpu())
        for name, rng in self._host_streams():
            if name in extra:
                _set_rng_state(rng, extra[name])

    # -- epochs -------------------------------------------------------------
    def train(self):
        """The epochs from ``start_epoch`` on; closes the loaders at the
        end, which stops their worker processes."""
        try:
            self._train()
        finally:
            _close(self.data_loader)
            _close(self.val_data_loader)

    def _train(self):
        config = self.config
        if self.state is None:
            self.init_state()
        if self.val_data_loader is not None and config.test_valid:
            val = self._valid_epoch()
            for k, v in val.items():
                self.writer.add_scalar(f"val/{k}", v, 0)

        for epoch in range(self.start_epoch, config.max_epoch + 1):
            self._train_epoch(epoch)
            if self.val_data_loader is not None and epoch % config.val_epoch_freq == 0:
                val = self._valid_epoch()
                for k, v in val.items():
                    self.writer.add_scalar(f"val/{k}", v, epoch)
                self._save(epoch, val, "checkpoint")
                cur = val[self.best_val_metric]
                # strict: of tied epochs the first stays the best, as in the
                # reference
                better = (
                    cur > self.best_val
                    if self.best_val_metric in self._MAX_METRICS
                    else cur < self.best_val
                )
                if better:
                    logging.info("new best %s=%.4f at epoch %d",
                                 self.best_val_metric, cur, epoch)
                    self.best_val, self.best_val_epoch = cur, epoch
                    self._save(epoch, val, "best_val_checkpoint")

    def _next_batch(self, it) -> PairBatch:
        self.data_timer.tic()
        batch = next(it)
        self.data_timer.toc()
        self.move_timer.tic()
        batch = self.move(batch)
        self.move_timer.toc()
        return batch

    def move(self, batch: PairBatch) -> PairBatch:
        """A loader's host batch on this Trainer's device."""
        return batch_to_device(batch, self.device)

    def _train_epoch(self, epoch: int):
        config = self.config
        self.total_timer, self.data_timer, self.move_timer = Timer(), Timer(), Timer()
        self.loss_meter = AverageMeter()
        total_timer, data_timer = self.total_timer, self.data_timer
        it = iter(self.data_loader)
        # iter_size gradient accumulation: n_iter optimizer steps consume
        # n_iter*iter_size loader batches (`lib/trainer.py:252-307` semantics)
        n_iter = len(self.data_loader) // max(config.iter_size, 1)
        if n_iter == 0:
            raise ValueError(
                f"loader yields {len(self.data_loader)} batches per epoch but "
                f"iter_size={config.iter_size} x data_parallel={self.n_devices}"
                f"; no optimizer step would run — "
                f"lower them or grow the dataset/batch split")
        try:
            for curr_iter in range(n_iter):
                total_timer.tic()
                batch = self._next_batch(it)
                if config.iter_size > 1:
                    # metrics stay device tensors per micro-step (a float()
                    # here would wait for the device); one read per group
                    group: Dict[str, torch.Tensor] = {}
                    for micro in range(config.iter_size):
                        if micro > 0:
                            batch = self._next_batch(it)
                        metrics = self.grad_step(self.state, batch, self.generator)
                        for k, v in metrics.items():
                            group[k] = group[k] + v if k in group else v
                    self.state = self.apply_step(self.state)
                    metrics = {k: float(v) / config.iter_size for k, v in group.items()}
                else:
                    self.state, metrics = self.train_step(self.state, batch, self.generator)
                loss = float(metrics["loss"])
                self.loss_meter.update(loss)
                total_timer.toc()
                if curr_iter % config.stat_freq == 0:
                    step = (epoch - 1) * n_iter + curr_iter
                    for k, v in metrics.items():
                        self.writer.add_scalar(f"train/{k}", float(v), step)
                    logging.info(
                        "Train Epoch: %d [%d/%d], Loss: %.3e  Data t: %.4f, Iter t: %.4f",
                        epoch, curr_iter, n_iter, loss, data_timer.avg, total_timer.avg,
                    )
        finally:
            _close(it)

    def _valid_epoch(self):
        config = self.config
        meters = {k: AverageMeter() for k in
                  ("loss", "rre", "rte", "success", "hit_ratio",
                   "feat_match_ratio", "corr_inliers", "irls_resid_med",
                   "irls_resid_inlier")}
        tot = len(self.val_data_loader)
        if config.val_max_iter > 0:
            tot = min(config.val_max_iter, tot)
        it = iter(self.val_data_loader)
        try:
            for i in range(tot):
                batch = self.move(next(it))
                gen = torch.Generator(device=self.device).manual_seed(i)
                out = self.val_step(batch, gen)
                out = {k: float(v) for k, v in out.items()}
                if not np.isnan(out["rre"]):
                    meters["rre"].update(out["rre"])
                for k in ("loss", "rte", "success", "hit_ratio",
                          "feat_match_ratio", "corr_inliers", "irls_resid_med",
                          "irls_resid_inlier"):
                    if k in out and not np.isnan(out[k]):
                        meters[k].update(out[k])
        finally:
            _close(it)
        result = {k: m.avg for k, m in meters.items()}
        if self.mesh is not None and self.mesh.world_size > 1:
            # every rank validates the whole split; all gate on rank 0's
            # result, so that all take part in the same checkpoint writes
            result = all_gather(self.mesh, result)[0]
        logging.info(
            "Validation: loss %.3f rte %.3f rre %.3f success %.3f "
            "hit_ratio %.3f fmr %.3f",
            result["loss"], result["rte"], result["rre"], result["success"],
            result["hit_ratio"], result["feat_match_ratio"],
        )
        return result

    def _save(self, epoch, val, name) -> Optional[str]:
        """The checkpoint's path; None on every rank but 0, which alone
        writes (the streams are gathered from every rank first)."""
        extra = self._streams()
        if not self.is_main:
            return None
        return save_checkpoint(
            self.out_dir, name, self.state, self.config, epoch,
            self.best_val, self.best_val_epoch, self.best_val_metric,
            val_value=val[self.best_val_metric], extra=extra,
        )
