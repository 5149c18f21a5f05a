"""Pair datasets that reject samples, and the rank function of fault 4's
two-rank run, shared by the port's loader tests
(``test_torch_port_loader_faults.py``, ``test_torch_port_loader_process.py``
and ``test_torch_port_trainer_dp.py``). It imports no JAX: the loaders'
worker processes and the rank processes import it to rebuild its
datasets."""
import numpy as np

from imfnet_tpu_torch.data import datasets as pds


class Rejects:
    """A pair dataset's mixin: the indices in ``reject`` are rejected with
    ``ValueError``, as a KITTI dataset rejects a pair with too few
    ground-truth matches, and ``fail`` raises an ``OSError``."""

    def __init__(self, phase, config, reject=(), fail=None, **kw):
        super().__init__(phase, config, **kw)
        self.reject, self.fail = set(reject), fail

    def __getitem__(self, idx):
        if idx in self.reject:
            raise ValueError(f"{idx}: too few matches")
        if idx == self.fail:
            raise OSError("disk gone")
        return super().__getitem__(idx)


class RejectingPairs(Rejects, pds.SyntheticPairDataset):
    """The port's synthetic pairs, rejecting as ``Rejects`` says."""


class AugmentedPairs(RejectingPairs):
    """``RejectingPairs`` through the 3DMatch datasets' augmentation and
    jitter, which draw from ``randg``."""

    def __getitem__(self, idx):
        p = super().__getitem__(idx)
        xyz0, xyz1, trans, radius = self._augment(p.xyz0, p.xyz1, p.T_gt.astype(np.float64))
        return self._finalize(xyz0, xyz1, trans, p.image0, p.image1, radius)


def run_rejecting_trainer(mesh, config, reject):
    """Rank function: the data-parallel ``Trainer`` of ``config`` on its
    sharded train split, where this rank's dataset (``AugmentedPairs``)
    rejects the indices in ``reject[rank]``. Returns (optimizer steps, steps
    an epoch, rejections of the last epoch, the pairs of each batch taken)."""
    from imfnet_tpu_torch.train.trainer import Trainer

    loader = pds.make_data_loader(config, "train", config.batch_size, device=mesh.device)
    loader.dataset = AugmentedPairs("train", config, reject=reject[mesh.rank],
                                    transform=pds._compose_jitter(),
                                    random_rotation=config.use_random_rotation)
    loader.dataset.reset_seed(config.seed)
    trainer = Trainer(config, loader, None, mesh=mesh)
    pairs, take = [], trainer._next_batch

    def next_batch(it):
        batch = take(it)
        pairs.append(int(batch.T_gt.shape[0]))
        return batch

    trainer._next_batch = next_batch
    trainer.train()
    return trainer.state.step, len(loader), loader.skip_count, pairs
