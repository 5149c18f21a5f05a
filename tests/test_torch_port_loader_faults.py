"""Fault 4 of the port, without ranks: a sharded training loader replaces a
sample that the dataset rejects, so that every rank yields ``len(loader)``
full batches and no rank is left in the gradient all-reduce alone; every
other loader keeps the reference's short batch, equal to the JAX loader's.
The process group's timeout is the backstop for a rank that still falls out
of step. The two-rank run of the fault is in
``test_torch_port_trainer_dp.py``."""
import os

import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data import datasets as jds

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data import datasets as pds
from imfnet_tpu_torch.parallel import mesh as pmesh

from test_torch_port_data import SMALL, _same_batch
from torch_port_rejecting import RejectingPairs as PortRejecting, Rejects

CFG = dict(SMALL, synthetic_length=8)


class JaxRejecting(Rejects, jds.SyntheticPairDataset):
    """The JAX package's synthetic pairs, rejecting as ``Rejects`` says."""


def _port_loader(reject=(), shard=None, drop_last=True, **kw):
    ds = PortRejecting("train", threedmatch_config(**CFG), reject=reject)
    return pds.PairLoader(ds, 2, CFG["max_points"], seed=3, shard=shard, drop_last=drop_last,
                          **kw)


def _jax_loader(reject=(), shard=None, drop_last=True):
    ds = JaxRejecting("train", jax_config(**CFG), reject=reject)
    return jds.PairLoader(ds, 2, CFG["max_points"], seed=3, shard=shard, drop_last=drop_last)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("reject", [(1,), (0, 5), (2, 3, 6)])
def test_a_sharded_loader_yields_full_batches(rank, reject):
    """shard=(rank, 2, 1): every batch holds two pairs, the epoch has
    len(loader) of them, no rejected sample is in them, each rejection is
    counted, and the replacements are the same in a second loader of the
    same seed."""
    loader = _port_loader(reject, shard=(rank, 2, 1))
    got = list(loader)
    assert len(got) == len(loader) == 2
    assert all(b.T_gt.shape[0] == 2 and b.image0.shape[0] == 2 for b in got)
    plan = loader.__class__(loader.dataset, 2, CFG["max_points"], seed=3,
                            shard=(rank, 2, 1))._epoch().plan
    drawn = [int(i) for _, sel in plan for i in sel]
    assert loader.skip_count >= sum(i in reject for i in drawn)
    kept = {loader.dataset[i].T_gt.tobytes() for i in range(8) if i not in reject}
    assert all(t.tobytes() in kept for b in got for t in b.T_gt.numpy())
    again = list(_port_loader(reject, shard=(rank, 2, 1)))
    for a, b in zip(got, again):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("shard", [(0, 2, 1), (1, 2, 1), (1, 2, 2)])
def test_without_a_rejection_the_sharded_batches_equal_the_jax_loaders(shard):
    pl, jl = _port_loader(shard=shard), _jax_loader(shard=shard)
    for _ in range(2):
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(pl) and pl.skip_count == 0
        for a, b in zip(got, want):
            _same_batch(a, b)


@pytest.mark.parametrize("shard,drop_last", [(None, True), (None, False), ((1, 2, 1), False)])
def test_other_loaders_keep_the_short_batch_of_the_jax_loader(shard, drop_last):
    """Unsharded, and sharded for evaluation (drop_last off, as
    ``for_rank`` makes it): a rejected sample is skipped, its batch is
    short, and the batches and the skip count equal the JAX loader's."""
    reject = (0, 2, 3, 5, 6)
    pl, jl = _port_loader(reject, shard, drop_last), _jax_loader(reject, shard, drop_last)
    got, want = list(pl), list(jl)
    assert len(got) == len(want) and pl.skip_count == jl.skip_count > 0
    assert any(b.T_gt.shape[0] == 1 for b in got)
    for a, b in zip(got, want):
        _same_batch(a, b)


def test_numbered_counts_the_rejected_batches_of_an_evaluation_loader():
    """``evaluate_kitti`` numbers pair i by its place in the test list: a
    batch the dataset rejects whole is skipped, and the numbers after it
    do not move."""
    ds = PortRejecting("test", threedmatch_config(**CFG), reject=(2,))
    loader = pds.PairLoader(ds, 1, CFG["max_points"], shuffle=False, drop_last=False)
    assert [i for i, _ in loader.for_rank(0, 2).numbered()] == [0, 4, 6]
    assert [i for i, _ in loader.numbered()] == [0, 1, 3, 4, 5, 6, 7]
    assert loader.skip_count == 1


def test_the_replacement_tries_are_bounded():
    loader = _port_loader(reject=range(8), shard=(0, 2, 1))
    with pytest.raises(RuntimeError, match=r"rejected every sample tried, 20 in all"):
        list(loader)
    assert loader.skip_count == 20


def test_a_process_group_starts_with_the_timeout(monkeypatch):
    """A one-rank group from ``make_mesh`` runs its collectives with
    PROCESS_GROUP_TIMEOUT; ``initialize_distributed`` passes it on as well,
    and turns on NCCL's asynchronous error handling."""
    mesh = pmesh.make_mesh(devices=["cpu"])
    try:
        backend = mesh.group._get_backend(torch.device("cpu"))
        assert backend.options._timeout == pmesh.PROCESS_GROUP_TIMEOUT
        pmesh.all_gather(mesh, 1)
    finally:
        pmesh.close_mesh()
    assert pmesh.PROCESS_GROUP_TIMEOUT.total_seconds() == 600

    seen = []
    monkeypatch.setattr(pmesh.dist, "init_process_group", lambda *a, **kw: seen.append((a, kw)))
    monkeypatch.setenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    pmesh.initialize_distributed("localhost:29512", 2, 1, backend="nccl")
    ((args, kw),) = seen
    assert args == ("nccl",) and kw["timeout"] == pmesh.PROCESS_GROUP_TIMEOUT
    assert kw["init_method"] == "tcp://localhost:29512" and (kw["world_size"], kw["rank"]) == (2, 1)
    assert os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "3"
