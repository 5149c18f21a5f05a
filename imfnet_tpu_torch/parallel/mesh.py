"""Ranks for data-parallel training and sharded evaluation over
``torch.distributed`` (``imfnet_tpu.parallel.mesh``).

Where the JAX package lays one process's devices out as a mesh and runs one
program over it, the port runs one process a device: a rank. ``make_mesh``
joins (or starts) the process group and returns this rank's record;
``spawn_ranks`` starts a host's ranks as processes (start method
``spawn``: the parent may have touched CUDA) and returns what each one's
function returned.

The backend comes from the device list, up front: NCCL when every rank has
a card of its own, gloo on the CPU or when ranks share a card (gloo
all-reduces CUDA tensors through the host). A failed NCCL start raises; it
never turns into gloo.
"""
from __future__ import annotations

import datetime
import logging
import os
import shutil
import tempfile
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

DP_AXIS = "dp"
# A collective that waits longer than this raises: far above a step or a
# checkpoint's gather, so that a rank that fell out of step fails loud
# instead of leaving the others in the all-reduce for good.
PROCESS_GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def _init_process_group(backend: str, **kw) -> None:
    """``dist.init_process_group`` with PROCESS_GROUP_TIMEOUT. Gloo raises
    in the collective that times out. NCCL acts on the timeout only with
    asynchronous error handling on: torch 2.2 and later read an unset
    TORCH_NCCL_ASYNC_ERROR_HANDLING as 3 (the watchdog aborts the
    communicator and ends the process), and a 0 would leave a timed-out
    collective waiting, so 0 and unset are set to 3 here."""
    if backend == "nccl" and os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0") == "0":
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "3"
    dist.init_process_group(backend, timeout=PROCESS_GROUP_TIMEOUT, **kw)


class Mesh(NamedTuple):
    """This rank's place among the ranks: the counterpart of a one-axis
    ``jax.sharding.Mesh`` seen from one device."""

    world_size: int
    rank: int
    device: torch.device
    group: Any          # the process group the collectives run on
    backend: str        # "nccl" or "gloo"


def mesh_backend(devices: Sequence, hosts: int = 1) -> str:
    """"nccl" when every device is a card and no card serves two ranks of
    one host (``devices`` in rank order, ``hosts`` equal blocks of it);
    "gloo" otherwise."""
    devs = [torch.device(d) for d in devices]
    per_host = len(devs) // hosts
    blocks = [devs[h * per_host:(h + 1) * per_host] for h in range(hosts)]
    if all(d.type == "cuda" for d in devs) and all(len(set(b)) == len(b) for b in blocks):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: str = "gloo") -> None:
    """Joins the process group of ``num_processes`` ranks as rank
    ``process_id``, meeting at ``coordinator_address`` (``host:port``, or a
    URL such as ``file:///path``). A no-op for one process, as in JAX."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError("initialize_distributed: more than one process needs a coordinator")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    _init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None, *,
              rank: int = 0, init_method: Optional[str] = None, hosts: int = 1) -> Mesh:
    """This rank's ``Mesh``. ``devices`` lists each rank's device in rank
    order (default: the first ``n_devices`` cards, or all of them);
    ``hosts`` splits it into equal per-host blocks.

    Joins the process group when none is up: with ``init_method`` as rank
    ``rank`` of ``len(devices)``, else, for one rank, over an in-process
    store, so that a one-rank mesh runs the real collectives of its backend.
    A group that is already up must have ``len(devices)`` ranks and the
    backend the devices ask for."""
    if devices is None:
        count = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(count if n_devices is None else n_devices)]
        if n_devices is not None and n_devices > count:
            raise ValueError(f"make_mesh: {n_devices} devices asked for, {count} cards there")
    devices = [torch.device(d) for d in devices]
    world = len(devices)
    if world == 0:
        raise ValueError("make_mesh: no devices")
    backend = mesh_backend(devices, hosts)
    if not dist.is_initialized():
        device = devices[rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if init_method is not None:
            initialize_distributed(init_method, world, rank, backend=backend)
        if not dist.is_initialized():
            if world != 1:
                raise ValueError(f"make_mesh: {world} ranks need an init_method "
                                 f"(spawn_ranks passes one)")
            _init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    if dist.get_world_size() != world:
        raise ValueError(f"make_mesh: the process group has {dist.get_world_size()} ranks, "
                         f"the device list {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs {dist.get_backend()}, the "
                         f"devices {[str(d) for d in devices]} ask for {backend}")
    rank = dist.get_rank()
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(world, rank, device, dist.group.WORLD, backend)


def close_mesh() -> None:
    """Leaves the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def float_buffers(module: torch.nn.Module) -> List[torch.Tensor]:
    """The module's floating-point buffers (running statistics), in order."""
    return [b for b in module.buffers() if b.is_floating_point()]


def mean_over_ranks(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Replaces each tensor by its mean over the ranks, in place, as
    ``jax.lax.pmean`` does: one all-reduce (sum) of the flattened tensors of
    each dtype, then a division by the world size. The copies in and out
    are one multi-tensor launch each, not one a tensor (a step averages
    several hundred). Returns ``tensors``."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat.div_(mesh.world_size)
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [p.view_as(t) for p, t in zip(parts, group)])
    return list(tensors)


def all_gather(mesh: Mesh, obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _rank_main(local: int, fn: Callable, args: tuple, devices: List[str],
               init_method: str, rank_offset: int, hosts: int, out_dir: str) -> None:
    rank = rank_offset + local
    if torch.device(devices[rank]).type == "cpu":
        # ranks share the host's cores, and one thread sums in the order a
        # one-thread process does
        torch.set_num_threads(1)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format=f"%(asctime)s [rank {rank}] %(message)s",
                        datefmt="%m/%d %H:%M:%S")
    mesh = make_mesh(devices=devices, rank=rank, init_method=init_method, hosts=hosts)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close_mesh()


def spawn_ranks(fn: Callable, devices: Sequence, args: tuple = (), *,
                init_method: Optional[str] = None, rank_offset: int = 0,
                hosts: int = 1) -> List[Any]:
    """Runs ``fn(mesh, *args)`` on this host's ranks, one process each, and
    returns their results in rank order.

    ``devices`` lists every rank's device (all hosts, rank order); this
    host's ranks are the ``len(devices) // hosts`` from ``rank_offset``.
    ``fn`` and ``args`` must pickle (``fn`` a function of an importable
    module). ``init_method`` is where the ranks meet; by default a file in a
    new temporary directory, which serves one host. A rank that raises
    fails the call."""
    devices = [str(torch.device(d)) for d in devices]
    n_local = len(devices) // hosts
    if n_local * hosts != len(devices):
        raise ValueError(f"spawn_ranks: {len(devices)} ranks do not split over {hosts} hosts")
    tmp = tempfile.mkdtemp(prefix="imfnet_ranks_")
    try:
        if init_method is None:
            if hosts != 1:
                raise ValueError("spawn_ranks: ranks on several hosts need an init_method")
            init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, tuple(args), devices, init_method, rank_offset, hosts, tmp),
            nprocs=n_local, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{rank_offset + i}.pt"), weights_only=False)
                for i in range(n_local)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
