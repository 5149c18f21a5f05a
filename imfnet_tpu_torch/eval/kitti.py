"""KITTI odometry evaluation: RANSAC success rate (RTE < 2 m, RRE < 5°)
(``imfnet_tpu.eval.kitti``).

`scripts/evaluation_kitti.py:29-147`: a loader of test pairs, the model on
both sides (``train.step.forward_pair`` in ``eval()``), feature-NN RANSAC
over every voxel (ransac_n from the config, distance threshold =
voxel_size), success accounting and timing meters. Pairs the dataset
rejected (<1000 ground-truth matches) are counted, not evaluated
(:66-70, `lib/data_loaders.py:588`). The draws of pair ``i`` come from a
generator on the device seeded with ``i``, where the JAX package passes
``PRNGKey(i)``; pair ``i`` is the i-th of the test list, where the JAX
package numbers the pairs it loaded (the two differ after a rejected pair).
With ``num_devices`` > 1 the pairs are split over the ranks of ``mesh``
(pair ``i`` loaded and registered on rank ``i mod D``) and gathered, so the
summary equals the one-device run's.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.eval.registration import make_pair_registration
from imfnet_tpu_torch.train.step import forward_pair
from imfnet_tpu_torch.train.trainer import batch_to_device
from imfnet_tpu_torch.utils.timer import AverageMeter, Timer


def registration_errors(T_gt, transformation):
    """(RTE m, RRE °) of a registration against KITTI's ground truth. The
    registration returns the gt.log-convention estimate (maps 1→0,
    `evaluation_3dmatch.py:182-187`); KITTI's ground truth maps 0→1."""
    T_est = np.linalg.inv(np.asarray(transformation))
    T_gt = np.asarray(T_gt)
    rte = np.linalg.norm(T_est[:3, 3] - T_gt[:3, 3])
    x = 0.5 * (np.trace(T_est[:3, :3].T @ T_gt[:3, :3]) - 1.0)
    return rte, np.degrees(np.arccos(np.clip(x, -1, 1)))


def evaluate_kitti(model: torch.nn.Module, config: Config, loader,
                   num_devices: int = 1, register=None, mesh=None) -> Dict:
    """``loader`` is a ``PairLoader`` of one pair a batch (random rotation
    off); the model runs on the device of its parameters. ``register(i,
    batch, f0, f1)`` replaces the default registration of pair ``i`` (its
    draws from a generator seeded with ``i``), pair ``i`` being the i-th of
    the loader's epoch, rejected pairs counted (``PairLoader.numbered``).
    ``num_devices`` > 1 (0: every rank of ``mesh``) needs ``mesh`` with that
    many ranks: each rank loads and registers its own pairs
    (``PairLoader.for_rank``, ``parallel.dp.make_parallel_kitti_eval``), and
    the transforms are gathered to all."""
    D = num_devices if num_devices else (mesh.world_size if mesh is not None else 1)
    if D > 1 and (mesh is None or mesh.world_size != D):
        raise ValueError(f"evaluate_kitti: num_devices={D} runs on as many ranks; "
                         f"this process is {'no rank' if mesh is None else mesh}")
    dev = next(model.parameters()).device
    register_pair = make_pair_registration(
        # the reference feeds the full voxelized clouds to RANSAC
        # (`evaluation_kitti.py:77-99`): num_keypoints = the pad capacity
        # makes the sampler keep every valid row
        num_keypoints=config.max_points,
        voxel_size=config.voxel_size,
        ransac_n=config.ransac_n,
        num_hypotheses=config.ransac_max_iteration,
        inlier_thresh=config.inlier_thresh,
        # KITTI's RANSAC distance is voxel_size * 1.0 (evaluation_kitti.py:99)
        distance_multiplier=1.0,
    )
    eye6 = torch.eye(6, device=dev)

    def default_register(i, batch, f0, f1):
        gen = torch.Generator(device=dev).manual_seed(i)
        return register_pair(batch.xyz0, f0, batch.n0, batch.xyz1, f1, batch.n1,
                             batch.T_gt[0], eye6, generator=gen)

    register = register or default_register
    rte_meter, rre_meter = AverageMeter(), AverageMeter()
    success_meter = AverageMeter()
    feat_timer, reg_timer = Timer(), Timer()

    def fail_count():
        # pairs the dataset rejected: PairLoader counts them as it skips
        return loader.skip_count

    def account(i, T_gt, transformation):
        rte, rre = registration_errors(T_gt, transformation)
        # success := RTE < 2 m and RRE < 5° (`scripts/evaluation_kitti.py:120-131`)
        if rte < 2.0 and not np.isnan(rre) and rre < 5.0:
            success_meter.update(1)
            rte_meter.update(rte)
            rre_meter.update(rre)
        else:
            success_meter.update(0)
            logging.info("failed pair %d: rte=%.3f rre=%.3f", i, rte, rre)
        if (i + 1) % 10 == 0:
            logging.info(
                "pair %d: RTE %.3f, RRE %.3f, Success %.4f (%d skipped), "
                "feat t %.3f, reg t %.3f", i, rte_meter.avg, rre_meter.avg,
                success_meter.avg, fail_count(), feat_timer.avg, reg_timer.avg)

    model.eval()
    # pair i is the i-th of the test list, a pair the dataset rejected
    # counted: its draws do not move with the rejections before it
    if D > 1:
        from imfnet_tpu_torch.parallel.dp import make_parallel_kitti_eval
        from imfnet_tpu_torch.parallel.mesh import all_gather

        loader = loader.for_rank(mesh.rank, D)     # each rank loads its own pairs

        def keep(i, batch, f0, f1):
            return {"T_gt": batch.T_gt[0],
                    "transformation": register(i, batch, f0, f1)["transformation"]}

        feat_timer.tic()
        done = make_parallel_kitti_eval(model, config, mesh, keep)(loader.numbered())
        feat_timer.toc()
        loader.close()          # this rank's copy: stops its worker process
        skipped = sum(all_gather(mesh, loader.skip_count))
        reg_timer.tic()
        for i, out in done:
            account(i, out["T_gt"].numpy(), out["transformation"].numpy())
        reg_timer.toc()
    else:
        for i, batch in loader.numbered():
            feat_timer.tic()
            batch = batch_to_device(batch, dev)
            with torch.no_grad():
                f0, f1 = forward_pair(model, batch, train=False, config=config)
                T = register(i, batch, f0, f1)["transformation"].cpu().numpy()
            feat_timer.toc()
            reg_timer.tic()
            account(i, batch.T_gt[0].cpu().numpy(), T)
            reg_timer.toc()
        skipped = fail_count()

    result = {
        "rte": rte_meter.avg,
        "rre": rre_meter.avg,
        "success_rate": success_meter.avg,
        "num_pairs": success_meter.count,
        "failed_loads": skipped,
    }
    logging.info("KITTI eval: %s", result)
    return result
