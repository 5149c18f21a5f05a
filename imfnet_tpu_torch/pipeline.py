"""Fragment-pair registration, end to end: the chain ``bench.py:351-400``
times for the JAX package.

``PairRegistrar`` builds the model once; each call takes one fragment pair
(raw points, images, ground-truth pose, covariance) and returns the metrics
of ``eval.registration.make_keypoint_registration``. Per pair it runs one
2-batch quantize, one coordinate pyramid, one model forward over
``images[2,H,W,3]``, keypoint sampling per fragment, and ``register_kp``
(both NN directions, RANSAC, metrics). The stages are public methods so a
caller can time them one by one.

A call on the card runs prepare and quantize eagerly (quantize reads the
voxel count back once, to pick the bucket), draws the keypoint keys and
RANSAC's uniforms, then replays one CUDA graph per bucket for the rest:
pyramid, forward, keypoints, both NN directions, RANSAC and the metrics,
as the JAX package's ``bench.py`` jits the forward and the registration
(``utils.graphs.jit``; ``graphed=False`` runs the stages eagerly).

While tracing (``utils.timer``), the host stages are the spans
``pipeline.prepare``, ``pipeline.quantize`` (with its voxel-count read,
``pipeline.quantize.read``) and ``pipeline.draws``; quantize counts the
bucket's ``rows_valid`` and ``rows_padded``; the graph's stages are
``pipeline.pyramid``, ``pipeline.forward``, ``pipeline.keypoints``, then
the registration's ``registration.nn`` and ``registration.ransac``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from imfnet_tpu_torch.config import Config, threedmatch_config
from imfnet_tpu_torch.eval.extract import DEFAULT_BUCKETS, pad_points_bucketed, pick_extent
from imfnet_tpu_torch.eval.registration import (make_keypoint_registration,
                                                sample_keypoints_segment)
from imfnet_tpu_torch.match.ransac import sample_shape
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.sparse.coords import SparseVoxels
from imfnet_tpu_torch.sparse.grid import COMPACT_IMPLS, GridSpec, quantize_grid
from imfnet_tpu_torch.sparse.kernel_map import CoordinatePyramid, coarse_levels_fit
from imfnet_tpu_torch.train.step import MAP_IMPLS, make_pyramid_fn
from imfnet_tpu_torch.utils import timer
from imfnet_tpu_torch.utils.device import resolve_device
from imfnet_tpu_torch.utils.graphs import jit

N_PAD_MAX = 1 << 15   # voxel capacity ceiling per fragment
HYPO_BLOCK = 12500    # RANSAC hypotheses scored at once


def bench_config() -> Config:
    """The configuration ``bench.py`` runs: 3DMatch defaults with level
    capacity divisors (1, 3, 8, 20)."""
    return threedmatch_config(level_capacity_divisors=(1, 3, 8, 20))


class PairBatch(NamedTuple):
    """One pair's raw points padded and concatenated as a 2-batch, on device."""

    xyz: torch.Tensor        # f32[B0 + B1, 3]
    batch: torch.Tensor      # int32[B0 + B1]
    valid: torch.Tensor      # bool[B0 + B1]
    images: torch.Tensor     # f32[2, H, W, 3]
    spec: GridSpec


class Quantized(NamedTuple):
    sv: SparseVoxels         # level-0 voxels of both fragments, 2-batch pad
    xyz_down: torch.Tensor   # f32[n_pad, 3] representative points
    n0: torch.Tensor         # int[] voxels of fragment 0 (rows [0, n0))
    spec: GridSpec           # the extent the voxels were quantized in


def init_model(config: Config, seed: int = 0) -> torch.nn.Module:
    """The config's model at full width with seeded random weights, in the
    inference configuration of the bench (occupancy conv1)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return load_model(config.model)(
            in_channels=config.in_channels,
            out_channels=config.model_n_out,
            conv1_kernel_size=config.conv1_kernel_size,
            normalize_feature=config.normalize_feature,
            compute_dtype=getattr(torch, config.compute_dtype),
            conv1_occupancy=True,
        )


class PairRegistrar:
    """Descriptor extraction and registration of fragment pairs.

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path. ``state_dict`` (for example
    from ``utils.flax_weights.state_dict_from_flax``) replaces the seeded
    random weights. ``compact_impl`` ("auto" or "kernel") goes to
    ``quantize_grid`` and ``map_impl`` ("search" or "banded") to
    ``make_pyramid_fn``, and any other value raises ``ValueError`` here; the
    packed-grid path is ``compact_impl="kernel", map_impl="banded"``, and
    every choice gives the same voxels and kernel maps. ``graphed`` (on the
    card) replays the stages after quantize as one CUDA graph per bucket;
    ``self.graphed`` is then its ``utils.graphs.Graphed``, else None."""

    def __init__(self, config: Optional[Config] = None, *, device=None,
                 state_dict=None, seed: int = 0, compact_impl: str = "auto",
                 map_impl: str = "search", graphed: bool = True):
        if compact_impl not in COMPACT_IMPLS:
            raise ValueError(f"PairRegistrar: compact_impl must be one of "
                             f"{COMPACT_IMPLS}, got {compact_impl!r}")
        if map_impl not in MAP_IMPLS:
            raise ValueError(f"PairRegistrar: map_impl must be one of {MAP_IMPLS}, "
                             f"got {map_impl!r}")
        self.device = resolve_device(device)
        self.graphed = (jit(self.chain, clone=True) if graphed and self.device.type == "cuda"
                        else None)
        self.config = config if config is not None else bench_config()
        self.compact_impl = compact_impl
        self.map_impl = map_impl
        model = init_model(self.config, seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        c = self.config
        self.register_kp = make_keypoint_registration(
            voxel_size=c.voxel_size, ransac_n=c.ransac_n,
            num_hypotheses=c.ransac_max_iteration, inlier_thresh=c.inlier_thresh,
            hypo_block=HYPO_BLOCK)
        self.sample_shape = sample_shape(c.ransac_max_iteration, HYPO_BLOCK, c.ransac_n)

    # ---- stages -------------------------------------------------------
    def prepare(self, xyz0: np.ndarray, xyz1: np.ndarray, image0: np.ndarray,
                image1: np.ndarray) -> PairBatch:
        """Host side: pad each fragment's raw points to its bucket, pick the
        grid-extent bucket, and move the 2-batch to the device."""
        with timer.span("pipeline.prepare"):
            c = self.config
            raw0, n0 = pad_points_bucketed(np.asarray(xyz0, np.float32))
            raw1, n1 = pad_points_bucketed(np.asarray(xyz1, np.float32))
            ext0 = pick_extent(raw0, n0, c.voxel_size, c)
            ext1 = pick_extent(raw1, n1, c.voxel_size, c)
            extent = (tuple(c.grid_extent) if ext0 is None or ext1 is None
                      else max(ext0, ext1))
            b0, b1 = len(raw0), len(raw1)
            valid = np.zeros(b0 + b1, bool)
            valid[:n0] = True
            valid[b0:b0 + n1] = True
            batch = np.concatenate([np.zeros(b0, np.int32), np.ones(b1, np.int32)])
            images = np.stack([np.asarray(image0, np.float32),
                               np.asarray(image1, np.float32)])
            dev = self.device
            return PairBatch(
                torch.from_numpy(np.concatenate([raw0, raw1])).to(dev),
                torch.from_numpy(batch).to(dev), torch.from_numpy(valid).to(dev),
                torch.from_numpy(images).to(dev), GridSpec(extent=extent, num_batches=2))

    def quantize(self, pb: PairBatch) -> Quantized:
        """One 2-batch quantize at the voxel ceiling, then the rows cut to
        the smallest 2-batch bucket that holds them (scan order keeps valid
        rows in front, so the cut equals quantizing at that bucket). Reads
        the voxel count back to the host once."""
        with timer.span("pipeline.quantize"):
            n = pb.xyz.shape[0]
            ones = torch.ones((n, 1), device=self.device)
            sv, _, xyz_down = quantize_grid(pb.xyz, ones, pb.valid,
                                            self.config.voxel_size, 2 * N_PAD_MAX,
                                            pb.spec, batch_index=pb.batch,
                                            compact_impl=self.compact_impl)
            with timer.span("pipeline.quantize.read"):
                n_vox = int(sv.num_valid)
            n_pad = next((2 * b for b in DEFAULT_BUCKETS if 2 * b >= n_vox),
                         2 * N_PAD_MAX)
            timer.count("pipeline.quantize.rows_valid", n_vox)
            timer.count("pipeline.quantize.rows_padded", n_pad)
            sv = SparseVoxels(sv.coords[:n_pad], sv.feats[:n_pad], sv.num_valid)
            n0 = ((sv.coords[:, 0] == 0) & sv.mask()).sum()
            return Quantized(sv, xyz_down[:n_pad], n0, pb.spec)

    def pyramid(self, q: Quantized) -> CoordinatePyramid:
        """The coordinate pyramid at the bucket ``quantize`` chose from the
        level-0 count. A coarse level that fills its capacity
        (``level_capacity_divisors``) would give descriptors from a
        truncated pyramid, so it raises: on the card as a device-side
        assert (no host read), which surfaces at a later synchronize."""
        fn = make_pyramid_fn(self.config, q.sv.n_padded, q.spec.num_batches,
                             extent=q.spec.extent, map_impl=self.map_impl)
        pyr = fn(q.sv.coords, q.sv.num_valid)
        torch._assert_async(
            coarse_levels_fit(pyr),
            "PairRegistrar: a coarse pyramid level overflows its capacity "
            "(max rows // level_capacity_divisors); the pair needs a larger bucket")
        return pyr

    @torch.no_grad()
    def forward(self, q: Quantized, pyr: CoordinatePyramid,
                images: torch.Tensor) -> torch.Tensor:
        return self.model(q.sv, pyr, images)

    def match(self, q: Quantized, feats: torch.Tensor, T_gt, cov, *,
              generator: Optional[torch.Generator] = None,
              keypoint_u: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              samples: Optional[torch.Tensor] = None) -> dict:
        """Sample keypoints per fragment and register them. ``keypoint_u``
        (two f32[n_pad] uniform keys) and ``samples`` (RANSAC sample
        indices) replace the draws from ``generator``."""
        timer.stage("pipeline.keypoints")
        k = self.config.num_rand_keypoints
        n_rows = q.xyz_down.shape[0]
        u0, u1 = keypoint_u if keypoint_u is not None else (None, None)
        i0, ok0 = sample_keypoints_segment(0, q.n0, k, n_rows, device=self.device,
                                           generator=generator, u=u0)
        i1, ok1 = sample_keypoints_segment(q.n0, q.sv.num_valid - q.n0, k, n_rows,
                                           device=self.device,
                                           generator=generator, u=u1)
        T_gt = torch.as_tensor(T_gt, dtype=torch.float32, device=self.device)
        cov = torch.as_tensor(cov, dtype=torch.float32, device=self.device)
        return self.register_kp(q.xyz_down[i0], feats[i0], ok0,
                                q.xyz_down[i1], feats[i1], ok1, T_gt, cov,
                                generator=generator, samples=samples)

    def draws(self, q: Quantized, generator: Optional[torch.Generator] = None,
              keypoint_u=None, samples=None):
        """(keypoint_u, samples): the draws ``match`` would make from
        ``generator`` on ``q``, in its order (each side's keys, then RANSAC's
        uniforms), made now; given ones are kept."""
        with timer.span("pipeline.draws"):
            n_rows = q.xyz_down.shape[0]
            if keypoint_u is None:
                keypoint_u = tuple(torch.rand(n_rows, generator=generator,
                                              device=self.device) for _ in range(2))
            if samples is None:
                samples = torch.rand(self.sample_shape, generator=generator,
                                     device=self.device)
            return keypoint_u, samples

    def chain(self, q: Quantized, images: torch.Tensor, T_gt: torch.Tensor,
              cov: torch.Tensor, keypoint_u, samples) -> dict:
        """pyramid → forward → match on a quantized pair, with the draws
        given: what the card replays as one graph per bucket."""
        timer.stage("pipeline.pyramid")
        pyr = self.pyramid(q)
        timer.stage("pipeline.forward")
        feats = self.forward(q, pyr, images)
        return self.match(q, feats, T_gt, cov, keypoint_u=keypoint_u, samples=samples)

    # ---- the whole chain ----------------------------------------------
    def __call__(self, xyz0, xyz1, image0, image1, T_gt, cov,
                 generator: Optional[torch.Generator] = None, *,
                 keypoint_u=None, samples=None) -> dict:
        pb = self.prepare(xyz0, xyz1, image0, image1)
        q = self.quantize(pb)
        T_gt = torch.as_tensor(T_gt, dtype=torch.float32, device=self.device)
        cov = torch.as_tensor(cov, dtype=torch.float32, device=self.device)
        ku, s = self.draws(q, generator, keypoint_u, samples)
        if self.graphed is None:
            return self.chain(q, pb.images, T_gt, cov, ku, s)
        return self.graphed(q, pb.images, T_gt, cov, ku, s)
