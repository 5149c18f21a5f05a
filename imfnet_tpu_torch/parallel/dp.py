"""Data parallelism over ranks (``imfnet_tpu.parallel.dp``).

Training: each rank takes its own batch of fragment pairs; the step
averages gradients, running statistics and metrics over the ranks
(``train.step.make_train_step(mesh=)``), and every rank applies the same
optimizer step. ``make_emulated_dp_step`` is the one-process specification
the ranks are held to. Rank ``r`` draws from a generator seeded with
``rank_seed(seed, r)``, the counterpart of JAX's ``fold_in(key,
axis_index)``.

Evaluation: numbered items (fragments, pairs) are split over the ranks,
rank ``r`` of W computing items ``r, r + W, ...``; a rank reads only its
own items, and the results are gathered in item order where every rank
needs them (``gather_items``).

Where the JAX package stacks a group on a leading device axis
(``stack_batches``, ``put_stacked``), the port keeps the group as a
sequence and each rank takes its own item.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.parallel.mesh import Mesh, all_gather, float_buffers
from imfnet_tpu_torch.train.state import TrainState
from imfnet_tpu_torch.train.step import PairBatch, _apply, make_loss_fn, make_train_step

RANK_SEED_STRIDE = 1_000_003


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s training draws: ``seed`` itself for rank
    0, so that one rank draws as the one-device trainer does."""
    return seed + RANK_SEED_STRIDE * rank


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(rank_seed(seed, rank))


def make_parallel_train_step(config: Config, mesh: Mesh, map_impl: Optional[str] = None):
    """train_step(state, batch, generator=None, draws=None) → (state,
    metrics) on this rank's batch, averaged over the ranks."""
    return make_train_step(config, map_impl=map_impl, mesh=mesh)


def make_emulated_dp_step(config: Config, n_devices: int, map_impl: Optional[str] = None):
    """step(state, batches, generators=None, draws=None) → (state, metrics):
    the data-parallel step in one process. Device ``d`` computes its loss
    and gradients on ``batches[d]`` with ``generators[d]`` (or
    ``draws[d]``), its forward starting from the same old running buffers;
    gradients, the new float buffers and the metrics are summed in device
    order and divided by ``n_devices`` (what ``pmean`` computes); then one
    optimizer step. Integer buffers (batch counts) end as one device's,
    as on each rank."""

    def mean(xs):
        return sum(xs[1:], xs[0]) / n_devices

    def step(state: TrainState, batches: Sequence[PairBatch],
             generators: Optional[Sequence[torch.Generator]] = None,
             draws: Optional[Sequence] = None):
        model = state.model
        loss_fn = make_loss_fn(model, config, map_impl)
        params = list(model.parameters())
        bufs = float_buffers(model)
        every = list(model.buffers())
        old = [b.detach().clone() for b in every]
        grads, stats, metrics = [], [], []
        for d in range(n_devices):
            with torch.no_grad():
                for b, o in zip(every, old):
                    b.copy_(o)
            state.optimizer.zero_grad(set_to_none=True)
            loss, m = loss_fn(batches[d], None if generators is None else generators[d],
                              None if draws is None else draws[d])
            loss.backward()
            grads.append([None if p.grad is None else p.grad.detach().clone() for p in params])
            stats.append([b.detach().clone() for b in bufs])
            metrics.append(m)
        for i, p in enumerate(params):
            g = [gd[i] for gd in grads]
            p.grad = None if g[0] is None else mean(g)
        with torch.no_grad():
            for i, b in enumerate(bufs):
                b.copy_(mean([s[i] for s in stats]))
        out = {k: mean([m[k] for m in metrics]) for k in metrics[0]}
        _apply(state)
        return state, out

    return step


def stack_batches(batches: Sequence) -> tuple:
    """A group of per-device batches (or any items), one per rank."""
    return tuple(batches)


def _to(obj, device):
    if isinstance(obj, PairBatch):
        from imfnet_tpu_torch.train.trainer import batch_to_device

        return batch_to_device(obj, device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


def put_stacked(mesh: Mesh, stacked):
    """This rank's item of a group (a sequence, or a tensor with a leading
    device axis), on this rank's device."""
    if len(stacked) != mesh.world_size:
        raise ValueError(f"put_stacked: a group of {len(stacked)} for {mesh.world_size} ranks")
    return _to(stacked[mesh.rank], mesh.device)


def shard_pair_batches(mesh: Mesh, batches: Sequence[PairBatch]) -> PairBatch:
    """This rank's batch of a group of pair batches, on its device."""
    return put_stacked(mesh, batches)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcasts the module's parameters and buffers from rank 0, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def own_items(mesh: Mesh, n: int) -> range:
    """The items of a group of ``n`` this rank computes."""
    return range(mesh.rank, n, mesh.world_size)


def gather_items(mesh: Mesh, local: Dict[int, object], n: Optional[int] = None) -> list:
    """Every rank's ``{item: result}`` merged into a list of results in
    item order, on every rank; with ``n``, the items must be 0 .. n-1."""
    merged = {}
    for part in all_gather(mesh, local):
        merged.update(part)
    if n is not None and sorted(merged) != list(range(n)):
        raise RuntimeError(f"gather_items: items {sorted(merged)} of {n}")
    return [merged[i] for i in sorted(merged)]


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _stack(items: list):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    if isinstance(items[0], torch.Tensor):
        return torch.stack(items)
    return items


def make_parallel_registration(mesh: Mesh, *, voxel_size: float = 0.025, ransac_n: int = 3,
                               num_hypotheses: int = 50000, inlier_thresh: float = 0.1):
    """register(seeds[D], kp0[D,K,3], kd0[D,K,C], ok0[D,K], kp1, kd1, ok1,
    T_gt[D,4,4], cov[D,6,6]) → metrics with a leading D axis (CPU tensors):
    item ``i`` registered on its rank with the draws of a generator seeded
    with ``seeds[i]``, as the serial ``make_keypoint_registration`` is."""
    from imfnet_tpu_torch.eval.registration import make_keypoint_registration

    register_kp = make_keypoint_registration(voxel_size=voxel_size, ransac_n=ransac_n,
                                             num_hypotheses=num_hypotheses,
                                             inlier_thresh=inlier_thresh)
    dev = mesh.device

    def register(seeds, kp0, kd0, ok0, kp1, kd1, ok1, T_gt, cov):
        n = len(seeds)
        local = {}
        for i in own_items(mesh, n):
            gen = torch.Generator(device=dev).manual_seed(int(seeds[i]))
            args = [t[i].to(dev) for t in (kp0, kd0, ok0, kp1, kd1, ok1, T_gt, cov)]
            local[i] = _cpu(register_kp(*args, generator=gen))
        return _stack(gather_items(mesh, local, n))

    return register


def _own(mesh: Mesh, items: Iterable[Tuple[int, object]]):
    """The ``(i, item)`` of ``items`` this rank computes (i ≡ rank mod
    W); the others are passed over unread."""
    return ((i, item) for i, item in items if i % mesh.world_size == mesh.rank)


def make_sharded_extractor(model: torch.nn.Module, config: Config, mesh: Mesh, *,
                           n_pad: int, use_grid: Optional[bool] = None) -> Callable:
    """extract(fragments) → {i: (xyz_down[n_pad,3], feats[n_pad,C],
    num_valid, fits)}, CPU tensors: ``fragments`` yields numbered
    fragments ``(i, (xyz_raw[n_raw,3], n_raw, image[1,H,W,3]))`` and this
    rank extracts those with i ≡ rank (mod W) at one voxel pad
    (``eval.extract.make_extractor``; ``use_grid`` False takes the exact
    path). The others are not read, so a caller may give None for them and
    each rank loads only its own fragments. The results stay on the rank
    that computed them (``gather_items`` collects them): where the JAX
    function returns every device's, each rank here writes its own files.
    ``fits`` is False when a coarse level overflows its capacity
    (``coarse_levels_fit``); ``num_valid == n_pad`` means level 0 may have.
    Either way the fragment must be extracted again at a larger pad, never
    used truncated."""
    from imfnet_tpu_torch.eval.extract import make_extractor

    if use_grid is not None:
        config = config.replace(use_grid_maps=use_grid)
    one = make_extractor(model, config=config, n_pad=n_pad)

    def extract(fragments):
        out = {}
        for i, (xyz_raw, n_raw, image) in _own(mesh, fragments):
            xyz_down, feats, num_valid = one(xyz_raw, int(n_raw), np.asarray(image))
            out[i] = _cpu((xyz_down, feats, num_valid, torch.as_tensor(one.fits)))
        return out

    return extract


def make_parallel_kitti_eval(model: torch.nn.Module, config: Config, mesh: Mesh,
                             register: Callable) -> Callable:
    """fn(pairs) → [(i, out)] in pair order on every rank: ``pairs`` yields
    numbered pair batches ``(i, batch)``; this rank runs the forward of
    those with i ≡ rank (mod W) in ``eval()`` and ``out = register(i,
    batch, f0, f1)`` (CPU tensors), and every rank's results are gathered.
    A rank that iterates a loader sharded over the ranks
    (``PairLoader.for_rank``) loads only its own pairs."""
    from imfnet_tpu_torch.train.step import forward_pair

    def fn(pairs):
        local = {}
        model.eval()
        for i, batch in _own(mesh, pairs):
            batch = _to(batch, mesh.device)
            with torch.no_grad():
                f0, f1 = forward_pair(model, batch, train=False, config=config)
                local[i] = (i, _cpu(register(i, batch, f0, f1)))
        return gather_items(mesh, local)

    return fn


def make_parallel_eval_forward(model: torch.nn.Module, config: Config, mesh: Mesh) -> Callable:
    """fn(batches[D]) → (f0s, f1s): both sides' descriptors of each pair
    batch in ``eval()``, lists in batch order (CPU tensors)."""
    from imfnet_tpu_torch.train.step import forward_pair

    def fn(batches):
        n = len(batches)
        local = {}
        model.eval()
        for i in own_items(mesh, n):
            with torch.no_grad():
                local[i] = _cpu(forward_pair(model, _to(batches[i], mesh.device), train=False,
                                             config=config))
        items = gather_items(mesh, local, n)
        return [it[0] for it in items], [it[1] for it in items]

    return fn


def _on_device(obj, device):
    return obj.to(device) if isinstance(obj, torch.nn.Module) else obj


def call_with_mesh(mesh: Mesh, fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
                   call_args: Optional[tuple] = None):
    """``fn(*args, mesh=mesh, **kwargs)`` on this rank, with every module
    among the arguments moved to the rank's device: the rank function
    through which ``spawn_ranks`` runs a function of the package that takes
    a ``mesh`` (``eval.threedmatch.generate_descriptors``,
    ``eval.kitti.evaluate_kitti``). With ``call_args``, ``fn`` is one of the
    factories above and what it returns is called with them."""
    kwargs = {k: _on_device(v, mesh.device) for k, v in (kwargs or {}).items()}
    out = fn(*(_on_device(a, mesh.device) for a in args), mesh=mesh, **kwargs)
    return out if call_args is None else out(*call_args)


# ---- rank functions for spawn_ranks -------------------------------------

def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count in this process (A also by
    variant)."""
    from imfnet_tpu_torch.match.nn_kernel import flash_nn
    from imfnet_tpu_torch.sparse.conv_kernel import gather_gemm
    from imfnet_tpu_torch.sparse.quant_kernel import sorted_compact
    from imfnet_tpu_torch.sparse.word_map_kernel import word_match_many

    return {"sparse_conv_gather_gemm": gather_gemm.launches, "flash_nn": flash_nn.launches,
            "sorted_compact": sorted_compact.launches, "word_match": word_match_many.launches,
            "sparse_conv_gather_gemm.tc": gather_gemm.launches_tc,
            "sparse_conv_gather_gemm.cin1": gather_gemm.launches_cin1,
            "sparse_conv_gather_gemm.scalar": gather_gemm.launches_scalar,
            "sparse_conv_gather_gemm.tcw": gather_gemm.launches_tcw}


def train_state_arrays(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state's module tensors and momentum buffers, on the CPU."""
    opt = state.optimizer
    params = dict(state.model.named_parameters())
    momentum = {name: opt.state[p]["momentum_buffer"].detach().cpu()
                for name, p in params.items()
                if p in opt.state and opt.state[p].get("momentum_buffer") is not None}
    return {"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "momentum": momentum}


def run_dp_steps(mesh: Mesh, config: Config, model_state: Dict[str, torch.Tensor],
                 batches: Sequence[Sequence[PairBatch]], map_impl: Optional[str] = None,
                 steps_per_epoch: int = 100) -> dict:
    """Rank function: the data-parallel step on ``batches[s][rank]`` for
    each step ``s``, from the module state ``model_state``, with this rank's
    generator (``rank_generator(config.seed, rank)``). Returns the state's
    tensors (``train_state_arrays``), the metrics and wall ms of each step
    and this rank's kernel launches per step."""
    from imfnet_tpu_torch.train.state import create_train_state
    from imfnet_tpu_torch.train.trainer import build_model_from_config

    model = build_model_from_config(config).to(mesh.device)
    model.load_state_dict(model_state)
    state = create_train_state(model, config, steps_per_epoch)
    step = make_parallel_train_step(config, mesh, map_impl)
    gen = rank_generator(config.seed, mesh.rank, mesh.device)
    before = kernel_launches()
    metrics, ms = [], []
    for group in batches:
        batch = shard_pair_batches(mesh, stack_batches(group))
        dist.barrier(group=mesh.group)
        t = time.perf_counter()
        state, m = step(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()})
        ms.append((time.perf_counter() - t) * 1e3)
    after = kernel_launches()
    return dict(train_state_arrays(state), metrics=metrics, ms=ms,
                launches={k: (after[k] - before[k]) / max(len(batches), 1) for k in after})


def call_counted(mesh: Mesh, fn: Callable, args: tuple = (), warm_args: Optional[tuple] = None):
    """(``fn(mesh, *args)``, this rank's kernel launches during the call,
    the call's wall seconds: the rank's process start excluded). With
    ``warm_args``, ``fn(mesh, *warm_args)`` runs first, uncounted: a
    process's first call holds its warm-up (allocator, library plans)."""
    if warm_args is not None:
        fn(mesh, *warm_args)
    before, t = kernel_launches(), time.perf_counter()
    out = fn(mesh, *args)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    seconds = time.perf_counter() - t
    after = kernel_launches()
    return out, {k: after[k] - before[k] for k in after}, seconds


def run_trainer(mesh: Mesh, config: Config, device=None, return_state: bool = False,
                resume_dir: Optional[str] = None, workers: Optional[int] = None):
    """Rank function: ``Trainer.train()`` on this rank (the train loader
    sharded over the ranks, validation whole on each), the config's
    ``resume`` included, or the last checkpoint under ``resume_dir``.
    ``workers`` is the train loader's (``make_data_loader``). With
    ``return_state``, returns the trained state's tensors
    (``train_state_arrays``), its step count, and this rank's kernel
    launches in its training and in its validation epochs with the steps of
    each; else None."""
    from imfnet_tpu_torch.data.datasets import make_data_loader
    from imfnet_tpu_torch.train.checkpoint import last_checkpoint
    from imfnet_tpu_torch.train.trainer import Trainer

    if resume_dir is not None:
        config = config.replace(resume=last_checkpoint(resume_dir))
    device = mesh.device if device is None else device
    train_loader = make_data_loader(config, "train", config.batch_size, device=device,
                                    workers=workers)
    val_loader = make_data_loader(config, "val", config.val_batch_size, device=device)
    trainer = Trainer(config, train_loader, val_loader, mesh=mesh)
    trainer.init_state()
    counts = {kind: dict(steps=0, **dict.fromkeys(kernel_launches(), 0))
              for kind in ("train", "val")}
    train_epoch, valid_epoch = trainer._train_epoch, trainer._valid_epoch

    def count(kind, fn, *args):
        before, step0 = kernel_launches(), trainer.state.step
        out = fn(*args)
        for k, v in kernel_launches().items():
            counts[kind][k] += v - before[k]
        counts[kind]["steps"] += (trainer.state.step - step0 if kind == "train" else
                                  min(config.val_max_iter or len(val_loader), len(val_loader)))
        return out

    trainer._train_epoch = lambda epoch: count("train", train_epoch, epoch)
    trainer._valid_epoch = lambda: count("val", valid_epoch)
    trainer.train()
    if not return_state:
        return None
    return dict(train_state_arrays(trainer.state), step=trainer.state.step, launches=counts)


def solo(mesh: Mesh, fn: Callable, args: tuple = ()):
    """Rank function: ``fn(one, *args)`` on rank 0 alone, ``one`` being a
    one-rank view of it with no process group (a function of the package
    then takes its one-device path); the other ranks return None at once.
    Inside ``run_calls`` they wait for rank 0 at its barrier."""
    if mesh.rank != 0:
        return None
    return fn(mesh._replace(world_size=1, group=None), *args)


def run_calls(mesh: Mesh, calls: Sequence[Tuple[Callable, tuple]]) -> list:
    """Rank function: ``fn(mesh, *args)`` for each ``(fn, args)`` of
    ``calls`` in order, in one process a rank, with a barrier after each
    (what rank 0 wrote is there for the next call). Returns each call's
    result and wall seconds."""
    out = []
    for fn, args in calls:
        t = time.perf_counter()
        result = fn(mesh, *args)
        dist.barrier(group=mesh.group)
        out.append((result, time.perf_counter() - t))
    return out
