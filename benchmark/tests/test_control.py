"""The control and the faults come out as not correct.

The control is the reference put in the program's place at float8 e4m3,
the precision below the configurations' bfloat16 (``control.py``); the
faults are planted in the program under a run of the harness (the chip's
look skipped, every other part of a run driven): an answer altered where it
is produced (a pose, a nearest-neighbour index), half of the batch left
out with the mean over the rest (in the forwards, or in the loss alone), a
training step that leaves its state unchanged. A run on one chip has no
exchange between chips to leave out. Sizes are the CPU's (``conftest
.SMALL``); the readings at the cells' own sizes are in PERF.md."""
import math
import time

import pytest
import torch

from benchlib import harness
from conftest import small_cell

SEED = (1 << 31) + 4321


def _correct(name) -> bool:
    res = harness.run(small_cell(name), seed=SEED, seconds=0.5, trace=False,
                      t_start=time.perf_counter(), device="cpu")
    return res["correct"]


def _fails(readings, limits) -> bool:
    return any(not (math.isfinite(readings[k]) and readings[k] <= lim)
               for k, lim in limits.items())


@pytest.mark.parametrize("name", ["3dmatch-pair", "3dmatch-extract", "kitti-pair"])
def test_the_program_passes_and_the_float8_control_fails(name):
    import control

    cell = small_cell(name)
    port, ctl = control.readings(cell, SEED, "cpu")
    limits = cell.workload["limits"]
    assert not _fails(port, limits), port
    assert _fails(ctl, limits), ctl


def test_the_training_control_and_faults_fail():
    import control

    cell = small_cell("3dmatch-train")
    drv = cell.driver(SEED, torch.device("cpu"))
    drv.setup()
    port, ctl, half, unchanged = control.train_readings(drv, "fp8")
    limits = cell.workload["limits"]
    assert not _fails(port, limits), port
    assert _fails(ctl, limits), ctl
    assert _fails(half, limits), half
    assert _fails(unchanged, limits), unchanged


def test_a_pose_altered_where_it_is_produced_fails(monkeypatch):
    from imfnet_tpu_torch.eval import registration
    from imfnet_tpu_torch.match.ransac import RansacResult

    real = registration.ransac_registration

    def altered(*a, **k):
        res = real(*a, **k)
        T = res.transformation.clone()
        T[:3, 3] += 0.5
        return RansacResult(T, *res[1:])

    monkeypatch.setattr(registration, "ransac_registration", altered)
    assert not _correct("3dmatch-pair")


def test_a_neighbour_index_altered_where_it_is_produced_fails(monkeypatch):
    from imfnet_tpu_torch.eval import registration

    real = registration.nn_auto

    def altered(queries, refs, ref_valid=None):
        idx, d2 = real(queries, refs, ref_valid)
        return torch.roll(idx, 1), d2          # each keypoint given its neighbour's match

    monkeypatch.setattr(registration, "nn_auto", altered)
    assert not _correct("kitti-pair")


@pytest.mark.parametrize("name", ["3dmatch-pair", "3dmatch-extract", "kitti-pair"])
def test_half_of_the_batch_left_out_fails(monkeypatch, name):
    from imfnet_tpu_torch.models.resunet import ResUNetIMF

    real = ResUNetIMF.forward

    def half(self, sv, pyramid, image):
        out = real(self, sv, pyramid, image)
        n = int(sv.num_valid) // 2            # the second half of the voxels left out
        return torch.cat([out[:n], torch.zeros_like(out[n:])])

    monkeypatch.setattr(ResUNetIMF, "forward", half)
    assert not _correct(name)


def test_a_training_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    assert not _correct("3dmatch-train")


def test_a_training_step_over_half_of_the_batch_fails(monkeypatch):
    from imfnet_tpu_torch.train import step

    real = step.forward_pair

    def first_pair_only(model, batch, **kw):
        # the forwards see the voxels of the batch's first pair alone
        n0 = (batch.coords0[:, 0] == 0).sum().to(batch.n0.dtype)
        n1 = (batch.coords1[:, 0] == 0).sum().to(batch.n1.dtype)
        return real(model, batch._replace(n0=n0, n1=n1), **kw)

    monkeypatch.setattr(step, "forward_pair", first_pair_only)
    assert not _correct("3dmatch-train")


def test_a_training_loss_over_half_of_the_batch_fails(monkeypatch):
    from imfnet_tpu_torch.train import step

    real_forward, real_loss = step.forward_pair, step.hardest_contrastive_loss
    seen = {}

    def forward(model, batch, **kw):
        seen["batch"] = batch                  # the forwards see the whole batch
        return real_forward(model, batch, **kw)

    def first_pair_loss(f0, valid0, f1, valid1, pairs, pair_valid, **kw):
        b = seen["batch"]
        valid0 = valid0 & (b.coords0[:, 0] == 0)
        valid1 = valid1 & (b.coords1[:, 0] == 0)
        return real_loss(f0, valid0, f1, valid1, pairs, pair_valid & valid0, **kw)

    monkeypatch.setattr(step, "forward_pair", forward)
    monkeypatch.setattr(step, "hardest_contrastive_loss", first_pair_loss)
    assert not _correct("3dmatch-train")
