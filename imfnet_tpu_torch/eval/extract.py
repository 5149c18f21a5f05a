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

As the JAX package jits them (``imfnet_tpu/eval/extract.py:144,196,204,224``),
the card replays CUDA graphs (``utils.graphs.jit``; ``graphed=False`` runs
eagerly, as the CPU always does): ``make_extractor`` one graph per path
(quantize, pyramid and forward), ``make_bucketed_extractor`` one quantize
graph per (raw bucket, path), then, after the host read of the voxel count,
one pyramid graph per (bucket, path) and, after the host read of
``coarse_levels_fit``, one forward graph per (bucket, path). Kernel C's
first capture at a size needs an eager call at that size before it: a
signature's first call, which ``jit`` runs eagerly, is that call.

While tracing (``utils.timer``), the bucketed extractor's host stages are
the spans ``extract.pad`` (``pad_points_bucketed``), ``extract.prepare``
(the extent bucket and the moves to the card), ``extract.read`` (each of
its two host reads: the voxel count, ``coarse_levels_fit``) and
``extract.copy_out`` (the copies of the results to the host); it counts
the voxel bucket's ``extract.rows_valid`` and ``extract.rows_padded``.
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
from imfnet_tpu_torch.utils import timer
from imfnet_tpu_torch.utils.graphs import jit


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
    with timer.span("extract.pad"):
        n = len(xyz)
        return pad_points(xyz, next((b for b in sorted(raw_buckets) if n <= b),
                                    max(raw_buckets)))


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


def _image_on(device, image) -> torch.Tensor:
    return torch.as_tensor(image, dtype=torch.float32).to(device)


def make_extractor(model: torch.nn.Module, *, config: Config, n_pad: int,
                   voxel_size: Optional[float] = None, graphed: bool = True):
    """Returns extract(xyz_raw[nraw,3], n_raw, image[1,H,W,3]) →
    (xyz_down[n_pad,3], feats[n_pad,C], num_valid), tensors on the model's
    device: one fixed voxel pad, the grid path at the smallest fitting
    extent bucket, else the exact path. ``extract.fits`` is the last call's
    ``coarse_levels_fit`` (a 0-d bool tensor): False where a coarse level
    filled its capacity and the descriptors come from a truncated pyramid.
    On the card (``graphed``) each path is one CUDA graph, whose outputs
    come back cloned; ``extract.graphed`` is its ``Graphed``, else None."""
    vox = voxel_size if voxel_size is not None else config.voxel_size
    dev = _model_device(model)

    @torch.no_grad()
    def body(xyz, valid, image, extent):
        sv, xyz_down = _quantize_fn(extent, vox, n_pad)(xyz, valid)
        pyr = _pyramid_fn(config, n_pad, extent)(sv.coords, sv.num_valid)
        model.eval()
        feats = model(sv, pyr, image)
        return xyz_down, feats, sv.num_valid, coarse_levels_fit(pyr)

    run = jit(body, clone=True) if graphed and dev.type == "cuda" else None

    def extract(xyz_raw, n_raw, image):
        extent = pick_extent(xyz_raw, n_raw, vox, config)
        xyz, valid = _raw_on(dev, xyz_raw, n_raw)
        xyz_down, feats, num_valid, extract.fits = (run or body)(
            xyz, valid, _image_on(dev, image), extent)
        return xyz_down, feats, num_valid

    extract.fits = None
    extract.graphed = run
    return extract


class ExtractChoice(NamedTuple):
    """What the bucketed extractor chose for its last fragment."""

    extent: Optional[Tuple[int, int, int]]   # None: the exact path
    voxels: int                              # level-0 voxel count
    bucket: int                              # the bucket that ran the model
    tried: Tuple[int, ...]                   # every bucket tried, in order


def make_bucketed_extractor(model: torch.nn.Module, *, config: Config,
                            buckets=DEFAULT_BUCKETS,
                            voxel_size: Optional[float] = None,
                            graphed: bool = True):
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
    ``ExtractChoice`` of the last call. On the card (``graphed``) the three
    stages replay CUDA graphs (the module's docstring);
    ``extract.graphed`` is {"quantize", "pyramid", "forward": Graphed},
    else None."""
    vox = voxel_size if voxel_size is not None else config.voxel_size
    n_max = buckets[-1]
    dev = _model_device(model)

    def quantize_max(xyz, valid, extent):
        return _quantize_fn(extent, vox, n_max)(xyz, valid)

    @torch.no_grad()
    def pyramid(coords, num_valid, bucket, extent):
        pyr = _pyramid_fn(config, bucket, extent)(coords[:bucket],
                                                  num_valid.clamp_max(bucket))
        return pyr, coarse_levels_fit(pyr)

    @torch.no_grad()
    def forward(coords, feats, num_valid, pyr, image, bucket):
        model.eval()
        sv = SparseVoxels(coords[:bucket], feats[:bucket], num_valid.clamp_max(bucket))
        return model(sv, pyr, image)

    stages = {"quantize": quantize_max, "pyramid": pyramid, "forward": forward}
    if graphed and dev.type == "cuda":
        stages = {k: jit(fn) for k, fn in stages.items()}

    def extract(xyz_raw, n_raw, image):
        with timer.span("extract.prepare"):
            extent = pick_extent(xyz_raw, n_raw, vox, config)
            xyz, valid = _raw_on(dev, xyz_raw, n_raw)
            image = _image_on(dev, image)
        sv, xyz_down = stages["quantize"](xyz, valid, extent)
        with timer.span("extract.read"):
            n = int(sv.num_valid)
        start = next((i for i, b in enumerate(buckets) if b >= n), len(buckets) - 1)
        tried = []
        for bucket in buckets[start:]:
            tried.append(bucket)
            pyr, fits = stages["pyramid"](sv.coords, sv.num_valid, bucket, extent)
            with timer.span("extract.read"):
                fits = bool(fits)
            if fits:
                break
            logging.warning("fragment's coarse pyramid levels overflow bucket %d "
                            "capacities — escalating", bucket)
        else:
            raise RuntimeError(
                f"make_bucketed_extractor: the coarse pyramid levels of a fragment "
                f"of {n} voxels overflow even the largest bucket {n_max}; add a "
                f"larger bucket or raise level_capacity_divisors")
        timer.count("extract.rows_valid", n)
        timer.count("extract.rows_padded", bucket)
        feats = stages["forward"](sv.coords, sv.feats, sv.num_valid, pyr, image, bucket)
        extract.last = ExtractChoice(extent, n, bucket, tuple(tried))
        with timer.span("extract.copy_out"):
            return xyz_down[:n].cpu().numpy(), feats[:n].float().cpu().numpy()

    extract.last = None
    extract.graphed = stages if graphed and dev.type == "cuda" else None
    return extract
