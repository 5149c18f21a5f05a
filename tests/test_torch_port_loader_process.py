"""Fault 2 of the port: ``PairLoader(workers=1)`` produces the batches in
one persistent worker process instead of a thread that holds the GIL the
training step's launches need. Its batches, rejection counts and the
dataset's augmentation stream are held bit-equal to the thread's
(``workers=0``, the JAX package's design); an early stop, a worker's
exception, a killed worker, ``close()`` and a collected loader each end as
stated, none with an unbounded wait; a ``Trainer`` fed by a worker process
resumes bit-equal to its uninterrupted run.

This module imports no JAX, and the trainer only where it runs one: the
worker processes import it. The datasets are ``torch_port_rejecting``'s."""
import gc
import glob
import multiprocessing
import os
import pickle
import time

import numpy as np
import pytest
import torch

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data import datasets as pds

from torch_port_rejecting import AugmentedPairs

SMALL = dict(dataset="SyntheticPairDataset", synthetic_length=6, synthetic_n_points=400,
             batch_size=2, max_points=2048, voxel_size=0.05, image_H=24, image_W=32)
DIED_WITHIN_S = 5.0    # a killed worker must raise in the consumer this soon


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the trainer's small CPU steps (see
    ``test_torch_port_trainer.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(config=None, **kw):
    ds = AugmentedPairs("train", config or threedmatch_config(**SMALL),
                   transform=pds._compose_jitter(), **kw)
    ds.reset_seed(5)
    return ds


def _loader(workers, ds=None, **kw):
    return pds.PairLoader(ds or _dataset(reject=(2,)), 2, SMALL["max_points"], seed=7,
                          workers=workers, **kw)


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for name, u, v in zip(x._fields, x, y):
            assert (u is None and v is None) or torch.equal(u, v), name


def _equal_states(a, b):
    return all(np.array_equal(u, v) for u, v in zip(a, b))


@pytest.fixture(scope="module")
def process_loader():
    """One worker process for the cases below (each sets what it needs);
    after them no child process is left."""
    loader = _loader(1)
    yield loader
    proc = loader._worker.proc if loader._worker is not None else None
    loader.close()
    assert proc is None or (not proc.is_alive() and proc not in multiprocessing.active_children())


@pytest.mark.parametrize("phase,on_card", [("train", 1), ("trainval", 1), ("val", 0),
                                            ("test", 0)])
def test_the_default_is_a_worker_for_a_training_split_on_a_card(phase, on_card):
    """``workers=None``: a worker process where the training split feeds a
    card; a thread for validation and test, and on the CPU. Built, not
    iterated, so no process starts."""
    cfg = threedmatch_config(**SMALL)
    assert pds.make_data_loader(cfg, phase, 2, device="cuda").workers == on_card
    assert pds.make_data_loader(cfg, phase, 2, device="cpu").workers == 0
    assert pds.make_data_loader(cfg, phase, 2, device="cuda", workers=1 - on_card).workers \
        == 1 - on_card


@pytest.mark.parametrize("shard", [None, (1, 2, 1)])
def test_process_batches_equal_the_threads_over_two_epochs(process_loader, shard):
    """Two epochs, unsharded (a short batch for the rejected sample) and
    sharded for training (its replacement is drawn in the worker): batches,
    numbering and skip counts bit-equal, and ``randg`` equal after each
    full epoch."""
    thread = _loader(0)
    proc = process_loader
    for lo in (thread, proc):
        lo.shard = shard
        lo.rng.seed(7)
        lo.dataset.reset_seed(5)
    for _ in range(2):
        a, b = list(thread.numbered()), list(proc.numbered())
        assert [i for i, _ in a] == [i for i, _ in b]
        _equal_batches([x for _, x in a], [x for _, x in b])
        assert thread.skip_count == proc.skip_count > 0
        assert _equal_states(thread.dataset.randg.get_state(), proc.dataset.randg.get_state())
        assert _equal_states(thread.rng.get_state(), proc.rng.get_state())
    if shard is not None:
        assert all(x.T_gt.shape[0] == 2 for _, x in b) and len(b) == len(proc)


def test_an_early_stop_leaves_the_stream_of_the_last_batch_taken(process_loader):
    """Closed after one batch, the parent's ``randg`` holds the state after
    that batch's draws, whatever the worker drew ahead; the next epoch
    starts from it, as the thread's would after ``randg`` is set to it
    (what a resume does)."""
    proc = process_loader
    proc.shard = None
    state0, order0 = proc.dataset.randg.get_state(), proc.rng.get_state()
    it = iter(proc)
    first = next(it)
    time.sleep(0.5)             # the worker draws ahead
    it.close()
    ref = pickle.loads(pickle.dumps(proc.dataset))
    ref.randg.set_state(state0)
    redo = _loader(0, ref)
    redo.rng.set_state(order0)
    epoch = redo._epoch()
    b, sel = epoch.plan[0]
    samples = pds._load_batch(ref, epoch, b, sel, lambda: 0)
    assert torch.equal(first.T_gt, torch.from_numpy(np.stack([s.T_gt for s in samples])))
    assert _equal_states(proc.dataset.randg.get_state(), ref.randg.get_state())

    thread = _loader(0)
    thread.rng.set_state(proc.rng.get_state())
    thread.dataset.randg.set_state(proc.dataset.randg.get_state())
    _equal_batches(list(thread), list(proc))


def test_the_worker_persists_and_an_early_stop_releases_it(process_loader):
    """The process twin of ``test_loader_thread_ends_when_the_consumer_stops_early``:
    the worker outlives an epoch and an early stop, which releases it at
    once (the next epoch is not held up behind the abandoned one)."""
    proc = process_loader
    proc.shard = None
    list(proc)
    worker = proc._worker
    it = iter(proc)
    next(it)
    it.close()
    assert worker.cancel.value == proc._epochs
    t = time.perf_counter()
    assert len(list(proc)) == len(proc)
    assert proc._worker is worker and worker.proc.is_alive()
    assert time.perf_counter() - t < 30


def test_a_killed_worker_raises_instead_of_hanging(process_loader):
    """Killed with two of its three batches still to come, the worker
    raises in the consumer within DIED_WITHIN_S."""
    proc = process_loader
    proc.shard = None
    it = iter(proc)
    next(it)
    worker = proc._worker
    worker.proc.kill()
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="worker process died"):
        for _ in it:
            pass
    assert time.perf_counter() - t < DIED_WITHIN_S
    worker.proc.join(DIED_WITHIN_S)
    assert not worker.proc.is_alive()


def test_a_worker_exception_reraises_and_a_collected_loader_ends_its_worker():
    """As the thread does (``test_loader_skips_value_errors_and_surfaces_the_rest``):
    the rejected sample is skipped, the OSError of another surfaces in the
    consumer with its type and message. Then the loader is dropped without
    ``close()``: its finalizer ends the worker."""
    loader = pds.PairLoader(_dataset(reject=(2,), fail=4), 2, SMALL["max_points"],
                            shuffle=False, workers=1)
    got = []
    with pytest.raises(OSError, match="disk gone"):
        for b in loader:
            got.append(b)
    assert len(got) == 2 and loader.skip_count == 1
    assert got[1].image0.shape[0] == 1
    proc = loader._worker.proc
    assert proc.is_alive()
    del loader, got
    gc.collect()
    assert not proc.is_alive() and proc not in multiprocessing.active_children()


def _trainer(out_dir, workers=1, **kw):
    """``test_torch_port_trainer.py``'s small trainer with one-step epochs
    (two pairs, one batch), its train split behind a worker process
    (``workers=1``) and drawing from its augmentation stream."""
    from imfnet_tpu_torch.train.trainer import Trainer

    base = dict(dataset="SyntheticPairDataset", synthetic_length=2, synthetic_n_points=400,
                batch_size=2, max_points=1024, voxel_size=0.05, conv1_kernel_size=3,
                model_n_out=16, num_pos_per_batch=64, num_hn_samples_per_batch=32,
                compute_dtype="float32", data_parallel=1, max_epoch=2, out_dir=str(out_dir),
                stat_freq=1, val_max_iter=1, lr=0.05, test_valid=False)
    base.update(kw)
    cfg = threedmatch_config(**base)
    train = pds.make_data_loader(cfg, "train", cfg.batch_size, device="cpu", workers=workers)
    train.dataset = AugmentedPairs("train", cfg, transform=pds._compose_jitter(),
                              random_rotation=cfg.use_random_rotation)
    train.dataset.reset_seed(cfg.seed)
    val = pds.make_data_loader(cfg, "val", cfg.val_batch_size, device="cpu")
    assert (train.workers, val.workers) == (workers, 0)
    return Trainer(cfg, train, val, device="cpu")


def _tensors(trainer):
    out = dict(trainer.state.model.state_dict())
    for i, st in trainer.state.optimizer.state_dict()["state"].items():
        out[f"momentum{i}"] = st["momentum_buffer"]
    return out


def test_a_trainer_fed_by_a_worker_resumes_bit_equal(tmp_path):
    """One epoch and a checkpoint with the worker, then a resume with a new
    one: bit-equal to the uninterrupted run, which takes the thread (equal
    batches, above), so the file starts one process less."""
    whole = _trainer(tmp_path / "whole", workers=0)
    whole.train()
    part = _trainer(tmp_path / "part", max_epoch=1)
    part.train()
    assert part.data_loader._worker is None           # train() closed it
    (ckpt,) = glob.glob(os.path.join(part.out_dir, "checkpoint_epoch_1_*"))
    rest = _trainer(tmp_path / "part", resume=ckpt)
    rest.init_state()
    assert rest.start_epoch == 2
    rest.train()
    a, b = _tensors(whole), _tensors(rest)
    assert a.keys() == b.keys() and whole.state.step == rest.state.step == 2
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert _equal_states(rest.data_loader.dataset.randg.get_state(),
                         whole.data_loader.dataset.randg.get_state())
