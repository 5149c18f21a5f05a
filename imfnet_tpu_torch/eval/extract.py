"""Host helpers that pick the static shapes of an extraction: raw-point
buckets, voxel buckets and the grid-extent bucket (numpy)."""
from __future__ import annotations

import logging
from typing import Tuple

import numpy as np

from imfnet_tpu_torch.config import Config


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
    span, or None when none does (the JAX package then takes its exact
    binary-search path; the port's quantizer needs an extent)."""
    if not config.use_grid_maps:
        return None
    for ext in extent_buckets(config):
        if _span_fits_grid(xyz_raw, n_raw, voxel_size, ext):
            return ext
    logging.warning("fragment voxel span exceeds grid_extent %s",
                    tuple(config.grid_extent))
    return None
