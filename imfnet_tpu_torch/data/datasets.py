"""Datasets and the batch loader (``imfnet_tpu.data.datasets``): 3DMatch /
3DImageMatch fragment pairs, the synthetic pairs, and a shuffling iterator
over padded batches.

Host-side mirror of `lib/data_loaders.py`:
- ThreeDMatchPairDataset / IndoorPairDataset (:206-348,717-723): pair lists
  from per-scene overlap txts, PLY + `_0.png`/`_0.jpg` image, random
  scale [0.8,1.2] (p=0.95) and random rotation augmentation, voxel dedup.
- ThreeDMatchTestDataset (:147-203): gt.log-driven raw test pairs.
- KITTIPairDataset / KITTINMPairDataset (:351-714): velodyne .bin pairs by
  time difference or >=10 m apart, ground truth from the odometry poses and
  velo2cam, refined by ICP (``match.icp``, on the device) and cached to .npy.
- make_data_loader (:730-772): shuffling iterator producing padded
  PairBatch, prefetched by a thread (the JAX package's design) or, where the
  loader feeds a card, by one worker process (the reference's DataLoader
  has worker processes).

Everything here is numpy and draws from ``RandomState`` streams in the JAX
package's order, so the same seed gives the same samples and batches. The
loader yields batches of host tensors; the trainer moves them to the card.
The positive search happens on the device in the train step
(``train.step.compute_correspondences``), not here.
"""
from __future__ import annotations

import copy
import glob
import logging
import multiprocessing
import os
import pathlib
import pickle
import queue
import threading
import traceback
import weakref
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.data.collate import VoxelizedPair, collate_pairs, voxelize_np
from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.geom.image import load_image, process_image
from imfnet_tpu_torch.geom.ply import read_ply
from imfnet_tpu_torch.geom.trajectory import read_trajectory
from imfnet_tpu_torch.geom.transforms import (Compose, Jitter, apply_transform_np,
                                              sample_random_trans)
from imfnet_tpu_torch.match.icp import icp_point_to_point
from imfnet_tpu_torch.utils.device import resolve_device
from imfnet_tpu_torch.utils.native import count_pairs_within_radius

_kitti_pose_cache = {}
_kitti_icp_cache = {}


def _resolve_data_file(path: str) -> str:
    """Split-list resolution: CWD-relative (reference layout) first, else the
    standard split lists shipped with the package (data/config/*.txt)."""
    if os.path.exists(path):
        return path
    pkg = os.path.join(os.path.dirname(__file__), "config", os.path.basename(path))
    if os.path.exists(pkg):
        return pkg
    raise FileNotFoundError(f"split list not found: {path} (also tried {pkg})")


def _read_split(path: str) -> List[str]:
    with open(_resolve_data_file(path)) as f:
        return f.read().split()


class PairDataset:
    """Base: augmentation state + config (`lib/data_loaders.py:107-144`)."""

    def __init__(self, phase: str, config: Config, random_rotation=True,
                 random_scale=True, manual_seed=False, transform=None):
        self.phase = phase
        self.files: List = []
        self.config = config
        self.transform = transform
        self.voxel_size = config.voxel_size
        self.matching_search_voxel_size = (
            config.voxel_size * config.positive_pair_search_voxel_size_multiplier
        )
        self.random_scale = random_scale
        self.min_scale = config.min_scale
        self.max_scale = config.max_scale
        self.random_rotation = random_rotation
        self.rotation_range = config.rotation_range
        self.randg = np.random.RandomState()
        if manual_seed:
            self.reset_seed()

    def reset_seed(self, seed=0):
        logging.info("Resetting the data loader seed to %d", seed)
        self.randg.seed(seed)

    def __len__(self):
        return len(self.files)

    # -- shared augmentation + voxelize tail of __getitem__ -----------------
    def _finalize(self, xyz0, xyz1, trans, image0, image1,
                  search_radius=0.0) -> VoxelizedPair:
        c0, sel0 = voxelize_np(xyz0, self.voxel_size)
        c1, sel1 = voxelize_np(xyz1, self.voxel_size)
        f0 = np.ones((len(c0), 1), np.float32)
        f1 = np.ones((len(c1), 1), np.float32)
        if self.transform is not None:
            c0, f0 = self.transform(self.randg, c0, f0)
            c1, f1 = self.transform(self.randg, c1, f1)
        return VoxelizedPair(
            coords0=c0.astype(np.int32), xyz0=xyz0[sel0].astype(np.float32),
            feats0=f0.astype(np.float32),
            coords1=c1.astype(np.int32), xyz1=xyz1[sel1].astype(np.float32),
            feats1=f1.astype(np.float32),
            image0=image0, image1=image1,
            T_gt=trans.astype(np.float32),
            search_radius=float(search_radius),
        )

    def _augment(self, xyz0, xyz1, base_trans=None):
        """Random scale + rotation (`lib/data_loaders.py:273-288,556-572`).
        Returns (xyz0', xyz1', trans, search_radius) with
        xyz1' ≈ trans @ xyz0'; search_radius is matching_search_voxel_size
        scaled by the sampled scale (`lib/data_loaders.py:273-276`)."""
        search_radius = self.matching_search_voxel_size
        if self.random_scale and self.randg.rand() < 0.95:
            scale = self.min_scale + (self.max_scale - self.min_scale) * self.randg.rand()
            search_radius *= scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1
        if self.random_rotation:
            T0 = sample_random_trans(xyz0, self.randg, self.rotation_range)
            T1 = sample_random_trans(xyz1, self.randg, self.rotation_range)
            mid = base_trans if base_trans is not None else np.eye(4)
            trans = T1 @ mid @ np.linalg.inv(T0)
            xyz0 = apply_transform_np(xyz0, T0)
            xyz1 = apply_transform_np(xyz1, T1)
        else:
            trans = base_trans if base_trans is not None else np.eye(4)
        return xyz0, xyz1, trans, search_radius

    def _load_image_for(self, ply_or_bin_path: str) -> np.ndarray:
        for suffix in ("_0.png", "_0.jpg", ".png"):
            p = ply_or_bin_path.rsplit(".", 1)[0] + suffix
            if os.path.exists(p):
                img = load_image(p)
                return process_image(img, self.config.image_H, self.config.image_W)
        # missing image → zeros (keeps the pipeline total; callers that train
        # multimodal models should ensure images exist)
        return np.zeros((self.config.image_H, self.config.image_W, 3), np.float32)


class IndoorPairDataset(PairDataset):
    """3DImageMatch fragment pairs from overlap txt lists
    (`lib/data_loaders.py:206-348`)."""

    DATA_FILES = {}

    def __init__(self, phase, config, **kw):
        super().__init__(phase, config, **kw)
        self.root = config.threed_match_dir
        for name in _read_split(self.DATA_FILES[phase]):
            fnames_txt = glob.glob(os.path.join(config.overlap_path, name + "*"))
            if not fnames_txt:
                raise FileNotFoundError(
                    f"Missing overlap files for {name} under {config.overlap_path}")
            for fname_txt in fnames_txt:
                with open(fname_txt) as f:
                    content = f.readlines()
                for line in content:
                    parts = line.strip().split()
                    if parts:
                        self.files.append([parts[0], parts[1]])

    def __getitem__(self, idx) -> VoxelizedPair:
        file0 = os.path.join(self.root, self.files[idx][0])
        file1 = os.path.join(self.root, self.files[idx][1])
        xyz0 = read_ply(file0)["points"]
        xyz1 = read_ply(file1)["points"]
        image0 = self._load_image_for(file0)
        image1 = self._load_image_for(file1)
        xyz0, xyz1, trans, radius = self._augment(xyz0, xyz1)
        return self._finalize(xyz0, xyz1, trans, image0, image1, radius)


class ThreeDMatchPairDataset(IndoorPairDataset):
    OVERLAP_RATIO = 0.3
    DATA_FILES = {
        "train": "./config/train_3dmatch.txt",
        "val": "./config/val_3dmatch.txt",
        "test": "./config/test_3dmatch.txt",
    }


class ThreeDMatchTestDataset(PairDataset):
    """gt.log-driven raw test pairs (`lib/data_loaders.py:147-203`)."""

    DATA_FILES = {"test": "./config/test_3dmatch.txt"}

    def __init__(self, phase, config, scene_id=None, return_ply_names=False, **kw):
        if phase != "test":
            raise ValueError(f"ThreeDMatchTestDataset has a test phase only, got {phase!r}")
        super().__init__(phase, config, **kw)
        self.root = config.threed_match_dir
        subset_names = _read_split(self.DATA_FILES[phase])
        if scene_id is not None:
            subset_names = [subset_names[scene_id]]
        for sname in subset_names:
            traj_file = os.path.join(self.root, sname + "-evaluation/gt.log")
            if not os.path.exists(traj_file):
                raise FileNotFoundError(traj_file)
            for ctraj in read_trajectory(traj_file):
                self.files.append(
                    (sname, ctraj.metadata[0], ctraj.metadata[1], ctraj.pose)
                )
        self.return_ply_names = return_ply_names

    def __getitem__(self, idx):
        sname, i, j, T_gt = self.files[idx]
        ply0 = os.path.join(self.root, sname, f"cloud_bin_{i}.ply")
        ply1 = os.path.join(self.root, sname, f"cloud_bin_{j}.ply")
        if self.return_ply_names:
            return sname, ply0, ply1, T_gt
        return sname, read_ply(ply0)["points"], read_ply(ply1)["points"], T_gt


_VELO2CAM = None


def velo2cam() -> np.ndarray:
    """KITTI velodyne→cam0 extrinsics (`lib/data_loaders.py:408-420`)."""
    global _VELO2CAM
    if _VELO2CAM is None:
        R = np.array([
            7.533745e-03, -9.999714e-01, -6.166020e-04, 1.480249e-02,
            7.280733e-04, -9.998902e-01, 9.998621e-01, 7.523790e-03,
            1.480755e-02,
        ]).reshape(3, 3)
        T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01]).reshape(3, 1)
        _VELO2CAM = np.vstack((np.hstack([R, T]), [0, 0, 0, 1])).T
    return _VELO2CAM


class KITTIPairDataset(PairDataset):
    """Odometry pairs with time difference in [2, max_time_diff)
    (`lib/data_loaders.py:351-623`). The ICP refinement of a pair's ground
    truth runs on ``icp_device`` (default the card) when its .npy cache
    under ``config.icp_cache_path`` (default ``<kitti_root>/icp``) is
    missing."""

    DATA_FILES = {
        "train": "./config/train_kitti.txt",
        "val": "./config/val_kitti.txt",
        "test": "./config/test_kitti.txt",
    }
    TEST_RANDOM_ROTATION = False

    def __init__(self, phase, config, icp_device=None, **kw):
        if "random_rotation" in kw:
            kw["random_rotation"] = self.TEST_RANDOM_ROTATION
        super().__init__(phase, config, **kw)
        self.icp_device = icp_device
        self.root = os.path.join(config.kitti_root, "dataset")
        self.icp_path = config.icp_cache_path or os.path.join(config.kitti_root, "icp")
        pathlib.Path(self.icp_path).mkdir(parents=True, exist_ok=True)
        self.max_time_diff = config.kitti_max_time_diff
        self._build_file_list(_read_split(self.DATA_FILES[phase]))

    def _scan_ids(self, drive_id: int):
        fnames = glob.glob(self.root + "/sequences/%02d/velodyne/*.bin" % drive_id)
        assert len(fnames) > 0, f"no velodyne data for drive {drive_id} in {self.root}"
        return sorted(int(os.path.split(f)[-1][:-4]) for f in fnames)

    def _build_file_list(self, subset_names):
        for dirname in subset_names:
            drive_id = int(dirname)
            inames = self._scan_ids(drive_id)
            iset = set(inames)
            for start_time in inames:
                for time_diff in range(2, self.max_time_diff):
                    pair_time = time_diff + start_time
                    if pair_time in iset:
                        self.files.append((drive_id, start_time, pair_time))

    def _poses(self, drive: int) -> np.ndarray:
        path = self.root + "/poses/%02d.txt" % drive
        if path not in _kitti_pose_cache:
            _kitti_pose_cache[path] = np.genfromtxt(path)
        return _kitti_pose_cache[path]

    def _position(self, odometry: np.ndarray) -> np.ndarray:
        T = odometry.reshape(3, 4)
        return np.vstack((T, [0, 0, 0, 1]))

    def _velodyne_fn(self, drive: int, t: int) -> str:
        return self.root + "/sequences/%02d/velodyne/%06d.bin" % (drive, t)

    def _refined_gt(self, drive, t0, t1, xyz0, xyz1) -> np.ndarray:
        """ICP-refined ground truth, cached to .npy
        (`lib/data_loaders.py:527-554`) and in memory by the file's path."""
        fname = os.path.join(self.icp_path, "%d_%d_%d.npy" % (drive, t0, t1))
        if fname in _kitti_icp_cache:
            return _kitti_icp_cache[fname]
        if os.path.exists(fname):
            M2 = np.load(fname)
        else:
            poses = self._poses(drive)
            p0 = self._position(poses[t0])
            p1 = self._position(poses[t1])
            v2c = velo2cam()
            M = (v2c @ p0.T @ np.linalg.inv(p1.T) @ np.linalg.inv(v2c)).T
            _, sel0 = voxelize_np(xyz0, 0.05)
            _, sel1 = voxelize_np(xyz1, 0.05)
            M2 = self._run_icp(apply_transform_np(xyz0[sel0], M), xyz1[sel1],
                               device=self.icp_device) @ M
            # written whole under another name, then renamed: ranks that
            # read the same split never load a file half written
            tmp = f"{fname}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, M2)
            os.replace(tmp, fname)
        _kitti_icp_cache[fname] = M2
        return M2

    @staticmethod
    def _run_icp(xyz0_t: np.ndarray, xyz1: np.ndarray, threshold=0.2,
                 device=None) -> np.ndarray:
        """``icp_point_to_point`` (30 iterations) with both clouds padded to
        the next power of two of the larger one, as the JAX package pads."""
        dev = resolve_device(device)
        n_pad = 1 << int(np.ceil(np.log2(max(len(xyz0_t), len(xyz1), 2))))

        def pad(x):
            out = np.zeros((n_pad, 3), np.float32)
            out[: len(x)] = x
            return torch.from_numpy(out).to(dev)

        rows = torch.arange(n_pad, device=dev)
        T = icp_point_to_point(pad(xyz0_t), pad(xyz1), rows < len(xyz0_t),
                               rows < len(xyz1), torch.eye(4, device=dev), threshold,
                               iters=30)
        return T.cpu().numpy().astype(np.float64)

    def __getitem__(self, idx) -> VoxelizedPair:
        drive, t0, t1 = self.files[idx]
        fname0 = self._velodyne_fn(drive, t0)
        fname1 = self._velodyne_fn(drive, t1)
        xyz0 = np.fromfile(fname0, dtype=np.float32).reshape(-1, 4)[:, :3]
        xyz1 = np.fromfile(fname1, dtype=np.float32).reshape(-1, 4)[:, :3]
        image0 = self._load_image_for(fname0)
        image1 = self._load_image_for(fname0)  # the reference reads frame 0's image twice (:508-509)
        M2 = self._refined_gt(drive, t0, t1, xyz0, xyz1)

        if self.random_rotation:
            T0 = sample_random_trans(xyz0, self.randg, 45.0)  # pi/4, :557
            T1 = sample_random_trans(xyz1, self.randg, 45.0)
            trans = T1 @ M2 @ np.linalg.inv(T0)
            xyz0 = apply_transform_np(xyz0, T0)
            xyz1 = apply_transform_np(xyz1, T1)
        else:
            trans = M2
        radius = self.matching_search_voxel_size
        if self.random_scale and self.randg.rand() < 0.95:
            scale = self.min_scale + (self.max_scale - self.min_scale) * self.randg.rand()
            radius *= scale  # `lib/data_loaders.py:566-570`
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1
        sample = self._finalize(xyz0, xyz1, trans, image0, image1, radius)
        # pair rejection: the reference raises when the voxelized pair has
        # fewer than 1000 ground-truth correspondences
        # (`lib/data_loaders.py:586-588`); PairLoader counts these skips
        # (`scripts/evaluation_kitti.py:66-70`)
        n_matches = count_pairs_within_radius(
            apply_transform_np(sample.xyz0, trans), sample.xyz1, radius)
        if n_matches < 1000:
            raise ValueError(f"{drive}, {t0}, {t1}")
        return sample


class KITTINMPairDataset(KITTIPairDataset):
    """Pairs >= 10 m apart (`lib/data_loaders.py:626-714`)."""

    MIN_DIST = 10

    def _build_file_list(self, subset_names):
        for dirname in subset_names:
            drive_id = int(dirname)
            inames = self._scan_ids(drive_id)
            iset = set(inames)
            all_pos = np.array([self._position(p) for p in self._poses(drive_id)])
            Ts = all_pos[:, :3, 3]
            pdist = np.sqrt(((Ts.reshape(1, -1, 3) - Ts.reshape(-1, 1, 3)) ** 2).sum(-1))
            valid_pairs = pdist > self.MIN_DIST
            curr_time = inames[0]
            while curr_time in iset:
                next_time = np.where(valid_pairs[curr_time][curr_time:curr_time + 100])[0]
                if len(next_time) == 0:
                    curr_time += 1
                    continue
                next_time = next_time[0] + curr_time - 1
                if next_time in iset:
                    self.files.append((drive_id, curr_time, next_time))
                    curr_time = next_time + 1
                else:
                    curr_time += 1
        # problematic sequence (`lib/data_loaders.py:708-714`)
        for item in [(8, 15, 58)]:
            if item in self.files:
                self.files.remove(item)


class SyntheticPairDataset(PairDataset):
    """Self-contained synthetic dataset (no files needed) — used for smoke
    training, benchmarks, and CI. Not in the reference."""

    def __init__(self, phase, config, length=None, n_points=None, **kw):
        super().__init__(phase, config, **kw)
        self.files = list(range(
            length if length is not None else config.synthetic_length))
        self.n_points = n_points if n_points is not None else config.synthetic_n_points

    def __getitem__(self, idx) -> VoxelizedPair:
        # per-index deterministic in every phase: sample i is the same no
        # matter which loader draws it or in what order (train uses a
        # seed-mixed stream so train/val/test differ)
        if self.phase == "train":
            seed = (1_000_003 + idx * 7919 + self.config.seed) % (1 << 31)
        else:
            seed = idx
        rng = np.random.RandomState(seed)
        return synthetic_pair(
            rng,
            n_points=self.n_points,
            voxel_size=self.voxel_size,
            image_hw=(self.config.image_H, self.config.image_W),
        )


ALL_DATASETS = [ThreeDMatchPairDataset, KITTIPairDataset, KITTINMPairDataset,
                SyntheticPairDataset]
dataset_str_mapping = {d.__name__: d for d in ALL_DATASETS}


def dataset_class(name: str):
    """The dataset class a config names (``config.dataset``)."""
    if name not in dataset_str_mapping:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(dataset_str_mapping)}")
    return dataset_str_mapping[name]


# A sharded training loader replaces a rejected sample; a batch raises after
# this many rejections per pair it holds.
REPLACE_TRIES_PER_SLOT = 10
# how often a waiting side of the worker process looks whether the other
# side left: a stopped consumer, a dead worker, a dead parent (s)
_POLL_S = 0.1
# PairLoader.close(): how long the worker gets to leave, then after terminate()
_JOIN_S = 5.0
# how long a failed read waits to see whether the worker has died
_DEATH_S = 1.0


class _Epoch(NamedTuple):
    """What the producer needs of one epoch, drawn in the consumer's
    process: the shuffled order and the batches this loader keeps."""

    idx: np.ndarray         # the epoch's permutation of the dataset's indices
    plan: list              # (b, dataset indices of batch b), in order
    n_pad: int
    grid_extent: Optional[tuple]
    replace: bool           # replace a rejected sample (sharded training loader)
    seed: int


def _replacement(epoch: _Epoch, b: int, slot: int, tries: int) -> int:
    """The dataset index that takes the place of a rejected sample: a place
    in the epoch's order drawn from (seed, batch, slot, try) alone, so that
    no stream moves and a resumed run draws the same."""
    j = np.random.SeedSequence([epoch.seed, b, slot, tries]).generate_state(1)[0]
    return int(epoch.idx[int(j) % len(epoch.idx)])


def _load_batch(dataset, epoch: _Epoch, b: int, sel, on_skip: Callable[[], int]) -> list:
    """The samples of batch ``b`` (dataset indices ``sel``). A sample that
    the dataset rejects with ``ValueError`` is skipped, or, with
    ``epoch.replace``, replaced by ``_replacement`` draws until one is
    accepted. ``on_skip()`` counts each rejection and returns the count."""
    samples, rejected = [], []
    for slot, i in enumerate(sel):
        i, tries = int(i), 0
        while True:
            try:
                samples.append(dataset[i])
                break
            except ValueError as e:
                # skippable pair (e.g. KITTI <1000 matches,
                # `scripts/evaluation_kitti.py:66-70`)
                rejected.append(i)
                logging.warning("skipping pair %d (%s); %d skipped so far", i, e, on_skip())
                if not epoch.replace:
                    break
                if len(rejected) >= REPLACE_TRIES_PER_SLOT * len(sel):
                    raise RuntimeError(f"batch {b}: the dataset rejected every sample tried, "
                                       f"{len(rejected)} in all: {rejected}") from e
                tries += 1
                i = _replacement(epoch, b, slot, tries)
    return samples


def _produce(dataset, epoch: _Epoch, on_skip: Callable[[], int],
             stopped: Callable[[], bool]):
    """Yields ``(b, batch)`` for the batches of the epoch's plan, host
    tensors, until ``stopped()``; a batch whose every sample the dataset
    rejected is left out."""
    for b, sel in epoch.plan:
        if stopped():
            return
        samples = _load_batch(dataset, epoch, b, sel, on_skip)
        if samples:
            yield b, collate_pairs(samples, epoch.n_pad, grid_extent=epoch.grid_extent,
                                   device="cpu")


def _stream_state(rng: Optional[np.random.RandomState]):
    return None if rng is None else rng.get_state()


def _portable(e: BaseException) -> BaseException:
    """``e`` with the worker's traceback as a note, or, where it does not
    pickle, a RuntimeError that says what it was."""
    e.add_note("raised in the loader's worker process:\n" + "".join(
        traceback.format_exception(e)))
    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}\n{e.__notes__[-1]}")


def _worker_main(dataset, tasks, results, cancel) -> None:
    """The worker process of ``PairLoader(workers=1)``. Each task is one
    epoch, ``(n, _Epoch, the augmentation stream's state)``, or None to
    leave. Puts ``(kind, n, b, payload, stream state, rejections so far)``:
    a "batch" with the stream's state after it was drawn, then an "end", or
    an "error" with the exception. An epoch ``n`` is abandoned once
    ``cancel.value >= n``; the process leaves when its parent has died."""
    torch.set_num_threads(1)
    parent = multiprocessing.parent_process()

    def parent_gone() -> bool:
        return parent is not None and not parent.is_alive()

    results.cancel_join_thread()   # leaving never waits for a reader that is gone
    rng = getattr(dataset, "randg", None)
    while True:
        try:
            task = tasks.get(timeout=_POLL_S)
        except queue.Empty:
            if parent_gone():
                return
            continue
        if task is None:
            return
        n, epoch, state = task
        if state is not None:
            rng.set_state(state)
        skips = 0

        def on_skip() -> int:
            nonlocal skips
            skips += 1
            return skips

        def abandoned() -> bool:
            return cancel.value >= n or parent_gone()

        def put(kind, b=None, payload=None, state=None) -> bool:
            while not abandoned():
                try:
                    results.put((kind, n, b, payload, state, skips), timeout=_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            for b, batch in _produce(dataset, epoch, on_skip, abandoned):
                if not put("batch", b, batch, _stream_state(rng)):
                    break
            else:
                put("end", state=_stream_state(rng))
        except Exception as e:
            put("error", payload=_portable(e))


def _stop_worker(proc, tasks, results, cancel) -> None:
    """Asks the worker to leave, then terminates it, then kills it, each
    wait bounded by _JOIN_S."""
    cancel.value = np.iinfo(np.int64).max       # abandons whatever it produces
    tasks.put(None)
    proc.join(_JOIN_S)
    for end in (proc.terminate, proc.kill):
        if proc.is_alive():
            end()
            proc.join(_JOIN_S)
    for q in (tasks, results):
        q.cancel_join_thread()
        q.close()


class _Worker:
    """The producer of a ``PairLoader(workers=1)``: one persistent process
    (start method ``spawn``: a forked child of a process that has touched
    CUDA is unsafe) that is given the dataset once and an epoch a task, and
    sends batches back through a queue of ``prefetch`` places (tensors in
    shared memory). Stopped by ``close()`` or when the loader is collected."""

    def __init__(self, loader: "PairLoader"):
        ctx = mp.get_context("spawn")
        self.tasks = ctx.Queue()
        self.results = ctx.Queue(maxsize=loader.prefetch)
        # epochs up to this number are abandoned; no lock, so that a worker
        # killed at any moment cannot leave it held
        self.cancel = ctx.Value("q", 0, lock=False)
        self.proc = ctx.Process(target=_worker_main, name="PairLoader worker", daemon=True,
                                args=(loader.dataset, self.tasks, self.results, self.cancel))
        self.proc.start()
        self.close = weakref.finalize(loader, _stop_worker, self.proc, self.tasks,
                                      self.results, self.cancel)

    def get(self):
        """The next message; raises once the process has died."""
        while True:
            try:
                return self.results.get(timeout=_POLL_S)
            except queue.Empty:
                if not self.proc.is_alive():
                    raise RuntimeError(f"the loader's worker process died (exit code "
                                       f"{self.proc.exitcode})") from None
            except Exception as e:      # a batch whose sender died as it was sent
                self.proc.join(_DEATH_S)  # a killed process is reaped a moment later
                if self.proc.is_alive():
                    raise
                raise RuntimeError(f"the loader's worker process died (exit code "
                                   f"{self.proc.exitcode})") from e


class PairLoader:
    """Iterable over padded PairBatch (host tensors) with background
    prefetch (`make_data_loader` contract, `lib/data_loaders.py:730-772`).

    ``workers=0`` produces the batches in a thread, as the JAX package does;
    ``workers=1`` in one persistent worker process (``_Worker``), which
    keeps the GIL free for the consumer's launches. The batches are the
    same: the shuffle permutation is drawn here and sent with the epoch, and
    the dataset's augmentation stream (``dataset.randg``) lives in the
    worker, goes to it at each epoch's start and comes back with each batch.
    When an epoch's iterator ends or is closed, ``dataset.randg`` here
    holds the state after the last batch the consumer took (the end of the
    epoch's draws where it ran to the end)."""

    def __init__(self, dataset, batch_size: int, n_pad: int, shuffle=True,
                 seed=0, prefetch: int = 2, drop_last=True,
                 grid_extent=None, shard=None, workers: int = 0):
        if workers not in (0, 1):
            raise ValueError(f"PairLoader: workers is 0 (a thread) or 1 (a process), "
                             f"not {workers}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_pad = n_pad
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.grid_extent = grid_extent  # loud guard, see collate_pairs
        # data parallelism over processes: shard=(rank, world, group) keeps
        # only batch b when (b // group) % world == rank — contiguous groups
        # of ``group`` batches (= local devices per process) rotate over
        # processes, so the union over processes at each global step equals
        # the single-process epoch. Identical epoch seed on every process
        # keeps the permutations aligned. With drop_last (training) only
        # complete rounds (one group per rank) are kept, and a sample the
        # dataset rejects is replaced (``_replacement``): a ragged tail or a
        # short batch would give ranks unequal batch counts, and the rank
        # with the extra batch would enter the gradient all-reduce alone.
        # Without it (evaluation, no collective per batch) the tail is kept
        # and a rejected sample is skipped, as in the reference.
        self.shard = shard
        # samples dropped by ValueError (e.g. KITTI <1000-GT-match rejection,
        # `lib/data_loaders.py:588`); reset each __iter__
        self.skip_count = 0
        self.workers = workers
        self._worker: Optional[_Worker] = None   # started by the first epoch
        self._epochs = 0

    def _total_batches(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _keep_batch(self, b: int) -> bool:
        if self.shard is None:
            return True
        rank, world, group = self.shard
        rounds = (self._total_batches() // group) // world
        g = b // group
        return g % world == rank and (not self.drop_last or g // world < rounds)

    def __len__(self):
        t = self._total_batches()
        if self.shard is None:
            return t
        if not self.drop_last:
            return sum(map(self._keep_batch, range(t)))
        _, world, group = self.shard
        return ((t // group) // world) * group  # complete rounds only

    def for_rank(self, rank: int, world: int) -> "PairLoader":
        """This loader's batches for rank ``rank`` of ``world``: batch b
        when b ≡ rank (mod world), the ragged tail included, so that each
        rank loads only its own pairs (sharded evaluation)."""
        if self.shard is not None:
            raise ValueError("for_rank: the loader is sharded already")
        out = copy.copy(self)
        out.rng = np.random.RandomState()
        out.rng.set_state(self.rng.get_state())
        out.shard, out.drop_last, out.skip_count = (rank, world, 1), False, 0
        out._worker, out._epochs = None, 0
        return out

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _epoch(self) -> _Epoch:
        idx = self._epoch_indices()
        plan = []
        for b in range(self._total_batches()):
            if not self._keep_batch(b):
                continue
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(sel) < self.batch_size and self.drop_last:
                break
            plan.append((b, sel))
        return _Epoch(idx, plan, self.n_pad, self.grid_extent,
                      self.shard is not None and self.drop_last, self.seed)

    def __iter__(self):
        return (batch for _, batch in self.numbered())

    def numbered(self):
        """Iterates ``(b, batch)``: ``b`` is the batch's place in the
        epoch's order, counting the batches the dataset rejected."""
        self.skip_count = 0
        epoch = self._epoch()
        if self.workers:
            yield from self._from_process(epoch)
        else:
            yield from self._from_thread(epoch)

    def close(self) -> None:
        """Stops the worker process, if one runs; a later epoch starts a
        new one."""
        w, self._worker = self._worker, None
        if w is not None:
            w.close()

    def _from_thread(self, epoch: _Epoch):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()   # the consumer left before the epoch's end

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def on_skip() -> int:
            self.skip_count += 1
            return self.skip_count

        def producer():
            try:
                for item in _produce(self.dataset, epoch, on_skip, abandoned.is_set):
                    if not put(item):
                        return
            except BaseException as e:  # surface in the consumer thread —
                put(e)                  # a silent stop would truncate epochs
            finally:
                put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=_POLL_S)
                except queue.Empty:
                    if t.is_alive() or not q.empty():
                        continue
                    raise RuntimeError("the loader's producer thread ended without "
                                       "finishing its epoch") from None
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early (val_max_iter, an error) releases
            # the producer, which would otherwise wait on the full queue
            abandoned.set()

    def _from_process(self, epoch: _Epoch):
        if self._worker is None or not self._worker.proc.is_alive():
            self.close()
            self._worker = _Worker(self)
        w = self._worker
        self._epochs += 1
        n = self._epochs
        rng = getattr(self.dataset, "randg", None)
        state = _stream_state(rng)
        w.tasks.put((n, epoch, state))
        ended = False
        try:
            while True:
                kind, m, b, payload, batch_state, skips = w.get()
                if m != n:
                    continue    # left over from an epoch that was abandoned
                self.skip_count = skips
                if kind == "error":
                    raise payload
                state = batch_state
                if kind == "end":
                    ended = True
                    break
                yield b, payload
        finally:
            if not ended:
                w.cancel.value = n      # releases the worker at once
            if rng is not None:
                rng.set_state(state)


def make_data_loader(config: Config, phase: str, batch_size: int,
                     shuffle: Optional[bool] = None, device=None,
                     workers: Optional[int] = None) -> PairLoader:
    """The config's dataset for ``phase`` behind a PairLoader. ``device``
    is where a KITTI dataset refines uncached ground truth and where the
    batches go (default the card). ``workers`` is the loader's (0 a thread,
    1 a worker process); None takes 1 for the training split where it feeds
    a card, else 0: validation and test loaders are short and stopped early,
    and a worker's start would outweigh what it saves them. In a process
    group of several ranks the train split is sharded over them."""
    if phase not in ("train", "trainval", "val", "test"):
        raise ValueError(f"unknown phase {phase!r}")
    if shuffle is None:
        shuffle = phase != "test"
    Dataset = dataset_class(config.dataset)
    use_random_rotation = False
    use_random_scale = False
    transform = None
    if phase in ("train", "trainval"):
        use_random_rotation = config.use_random_rotation
        use_random_scale = config.use_random_scale
        transform = _compose_jitter()
    extra = {"icp_device": device} if issubclass(Dataset, KITTIPairDataset) else {}
    dset = Dataset(
        phase, config,
        random_rotation=use_random_rotation,
        random_scale=use_random_scale,
        transform=transform,
        **extra,
    )
    # deterministic augmentation stream (reference reproducibility aid:
    # `PairDataset.reset_seed`, `lib/data_loaders.py:133-135`, seeded at
    # `train_3DMatch.py:26-27`)
    dset.reset_seed(config.seed)
    # data parallelism: in a process group of several ranks the train split
    # is sharded, one batch a rank a step (step i of rank r takes batch
    # i·world + r, as the JAX package's device r does); validation and test
    # stay whole, so that every rank computes the same metrics
    shard = None
    if phase in ("train", "trainval") and dist.is_initialized() and dist.get_world_size() > 1:
        shard = (dist.get_rank(), dist.get_world_size(), 1)
    if workers is None:
        # a loader thread holds the GIL that the training step's launches need
        feeds_card = (torch.cuda.is_available() if device is None
                      else torch.device(device).type == "cuda")
        workers = int(feeds_card and phase in ("train", "trainval"))
    return PairLoader(dset, batch_size, config.max_points, shuffle=shuffle,
                      seed=config.seed, shard=shard, workers=workers,
                      grid_extent=(tuple(config.grid_extent)
                                   if config.use_grid_maps else None))


def _compose_jitter():
    return Compose([Jitter()])
