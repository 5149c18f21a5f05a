"""Descriptor extraction: raw points + image → (xyz_down, descriptors)
(``imfnet_tpu.eval.extract``; `extract_features`, `util/misc.py:21-104`).

Per fragment: voxel-quantize (occupancy-1 features), build the UNet
coordinate pyramid, and run the model in ``eval()`` under
``torch.no_grad()``. The host pads the raw points to a static bucket and
picks the path:
- **grid**, when the fragment's voxel span fits an extent bucket
  (``pick_extent``): ``quantize_grid(compact_impl="kernel")`` (kernel C)
  and the banded grid pyramid (kernel D);
- **exact**, when it fits none or ``config.use_grid_maps`` is off:
  ``sparse.coords.quantize`` and the search pyramid, no voxel dropped.
Both then run the model (kernel A). The extractors run on the device of the
model's parameters.
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.sparse.coords import SparseVoxels, quantize
from imfnet_tpu_torch.sparse.grid import GridSpec, quantize_grid
from imfnet_tpu_torch.sparse.kernel_map import coarse_levels_fit
from imfnet_tpu_torch.train.step import make_pyramid_fn


def pad_points(xyz: np.ndarray, n_raw_pad: int) -> Tuple[np.ndarray, int]:
    """Pad raw points to a static bucket; on overflow subsample with a loud
    warning (the reference quantizes all raw points)."""
    n = len(xyz)
    if n > n_raw_pad:
        logging.warning(
            "pad_points: fragment has %d raw points but the static bucket "
            "holds %d — randomly subsampling %d points.", n, n_raw_pad,
            n - n_raw_pad)
        sel = np.random.RandomState(0).choice(n, n_raw_pad, replace=False)
        xyz = xyz[sel]
        n = n_raw_pad
    out = np.zeros((n_raw_pad, 3), np.float32)
    out[:n] = xyz
    return out, n


# Raw-point buckets: 2^15 steps through the 3DMatch range, coarser above.
RAW_BUCKETS = (
    1 << 17, 1 << 18, 294912, 327680, 360448, 393216, 458752,
    1 << 19, 786432, 1 << 20,
)

# Voxel-count buckets per fragment.
DEFAULT_BUCKETS = (8192, 12288, 16384, 20480, 24576, 28672, 32768,
                   40960, 49152, 65536)


def pad_points_bucketed(xyz: np.ndarray, raw_buckets=RAW_BUCKETS
                        ) -> Tuple[np.ndarray, int]:
    """Pad raw points to the smallest bucket that holds them all."""
    n = len(xyz)
    for b in sorted(raw_buckets):
        if n <= b:
            return pad_points(xyz, b)
    return pad_points(xyz, max(raw_buckets))


def _span_fits_grid(xyz_raw, n_raw, voxel_size: float, extent) -> bool:
    pts = np.asarray(xyz_raw)[: int(n_raw)]
    if len(pts) == 0:
        return True
    v = np.floor(pts / voxel_size)
    span = v.max(0) - v.min(0) + 1
    return bool((span <= np.asarray(extent)).all())


def extent_buckets(config: Config):
    """Effective extent buckets, smallest first; ``grid_extent`` is the
    ceiling."""
    ge = tuple(config.grid_extent)
    eff = [tuple(b) for b in (config.grid_extent_buckets or ())
           if all(x <= y for x, y in zip(b, ge)) and tuple(b) != ge]
    return eff + [ge]


def pick_extent(xyz_raw, n_raw, voxel_size: float, config: Config):
    """Smallest configured extent bucket that holds the fragment's voxel
    span (a host min/max over the raw points), or None for the exact path
    (``sparse.coords.quantize`` and the search pyramid), which drops no
    point. Always None when ``config.use_grid_maps`` is off."""
    if not config.use_grid_maps:
        return None
    for ext in extent_buckets(config):
        if _span_fits_grid(xyz_raw, n_raw, voxel_size, ext):
            return ext
    logging.warning(
        "fragment voxel span exceeds grid_extent %s; using the exact"
        " search pyramid (no points dropped)", tuple(config.grid_extent))
    return None


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _quantize_fn(extent, voxel_size: float, n_out: int):
    """fn(xyz, valid) → (SparseVoxels, xyz_down) of one fragment: the grid
    quantizer through kernel C inside ``extent``, or the exact one."""
    def fn(xyz, valid):
        ones = torch.ones((xyz.shape[0], 1), device=xyz.device)
        if extent is None:
            sv, _, xyz_down = quantize(xyz, ones, valid, voxel_size, n_out)
        else:
            sv, _, xyz_down = quantize_grid(xyz, ones, valid, voxel_size, n_out,
                                            GridSpec(extent=extent, num_batches=1),
                                            compact_impl="kernel")
        return sv, xyz_down
    return fn


def _pyramid_fn(config: Config, n_pad: int, extent):
    return make_pyramid_fn(config, n_pad, num_batches=1, extent=extent,
                           map_impl="search" if extent is None else "banded")


def _raw_on(device, xyz_raw, n_raw):
    xyz = torch.as_tensor(np.asarray(xyz_raw, np.float32)).to(device)
    return xyz, torch.arange(xyz.shape[0], device=device) < int(n_raw)


def make_extractor(model: torch.nn.Module, *, config: Config, n_pad: int,
                   voxel_size: Optional[float] = None):
    """Returns extract(xyz_raw[nraw,3], n_raw, image[1,H,W,3]) →
    (xyz_down[n_pad,3], feats[n_pad,C], num_valid), tensors on the model's
    device: one fixed voxel pad, the grid path at the smallest fitting
    extent bucket, else the exact path. ``extract.fits`` is the last call's
    ``coarse_levels_fit`` (a 0-d bool tensor): False where a coarse level
    filled its capacity and the descriptors come from a truncated pyramid."""
    vox = voxel_size if voxel_size is not None else config.voxel_size
    dev = _model_device(model)

    @torch.no_grad()
    def extract(xyz_raw, n_raw, image):
        extent = pick_extent(xyz_raw, n_raw, vox, config)
        xyz, valid = _raw_on(dev, xyz_raw, n_raw)
        sv, xyz_down = _quantize_fn(extent, vox, n_pad)(xyz, valid)
        pyr = _pyramid_fn(config, n_pad, extent)(sv.coords, sv.num_valid)
        model.eval()
        feats = model(sv, pyr, torch.as_tensor(image, dtype=torch.float32).to(dev))
        extract.fits = coarse_levels_fit(pyr)
        return xyz_down, feats, sv.num_valid

    extract.fits = None
    return extract


class ExtractChoice(NamedTuple):
    """What the bucketed extractor chose for its last fragment."""

    extent: Optional[Tuple[int, int, int]]   # None: the exact path
    voxels: int                              # level-0 voxel count
    bucket: int                              # the bucket that ran the model
    tried: Tuple[int, ...]                   # every bucket tried, in order


def make_bucketed_extractor(model: torch.nn.Module, *, config: Config,
                            buckets=DEFAULT_BUCKETS,
                            voxel_size: Optional[float] = None):
    """Shape-bucketed extraction: quantize once at the largest bucket, read
    the voxel count back, then build the pyramid at the smallest bucket
    that holds it. Scan-ordered quantize output keeps valid rows in front,
    so a bucket is a row slice. A fragment whose coarse levels overflow
    their capacities (``level_capacity_divisors``) escalates to the next
    bucket: ``coarse_levels_fit`` is read back once per bucket tried, and
    the model runs once, at the first bucket that fits. Where even the
    largest bucket overflows, it raises (the JAX package logs an error and
    returns descriptors of a truncated pyramid).

    Returns extract(xyz_raw, n_raw, image) → (xyz_down[n,3], feats[n,C])
    numpy arrays cut to the voxel count n; ``extract.last`` is the
    ``ExtractChoice`` of the last call."""
    vox = voxel_size if voxel_size is not None else config.voxel_size
    n_max = buckets[-1]
    dev = _model_device(model)

    @torch.no_grad()
    def extract(xyz_raw, n_raw, image):
        extent = pick_extent(xyz_raw, n_raw, vox, config)
        xyz, valid = _raw_on(dev, xyz_raw, n_raw)
        sv, xyz_down = _quantize_fn(extent, vox, n_max)(xyz, valid)
        n = int(sv.num_valid)
        start = next((i for i, b in enumerate(buckets) if b >= n), len(buckets) - 1)
        tried = []
        for bucket in buckets[start:]:
            tried.append(bucket)
            coords = sv.coords[:bucket]
            n_b = sv.num_valid.clamp_max(bucket)
            pyr = _pyramid_fn(config, bucket, extent)(coords, n_b)
            if bool(coarse_levels_fit(pyr)):
                break
            logging.warning("fragment's coarse pyramid levels overflow bucket %d "
                            "capacities — escalating", bucket)
        else:
            raise RuntimeError(
                f"make_bucketed_extractor: the coarse pyramid levels of a fragment "
                f"of {n} voxels overflow even the largest bucket {n_max}; add a "
                f"larger bucket or raise level_capacity_divisors")
        model.eval()
        feats = model(SparseVoxels(coords, sv.feats[:bucket], n_b), pyr,
                      torch.as_tensor(image, dtype=torch.float32).to(dev))
        extract.last = ExtractChoice(extent, n, bucket, tuple(tried))
        return xyz_down[:n].cpu().numpy(), feats[:n].float().cpu().numpy()

    extract.last = None
    return extract
