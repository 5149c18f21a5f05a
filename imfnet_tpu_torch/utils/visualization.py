"""Registration views as coloured PLY files (``imfnet_tpu.utils.visualization``,
its ``save_registration_view`` only).

The reference (`util/visualization.py:98-645`) opens Open3D windows showing
registration before and after; a headless machine has no display, so the
view is written as a coloured PLY instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from imfnet_tpu_torch.geom.ply import write_ply
from imfnet_tpu_torch.geom.transforms import apply_transform_np

# the reference's two-cloud colouring (yellow/blue, `util/visualization.py`)
COLOR_SRC = np.array([1.0, 0.706, 0.0])
COLOR_DST = np.array([0.0, 0.651, 0.929])


def save_registration_view(path: str, xyz0: np.ndarray, xyz1: np.ndarray,
                           transform: Optional[np.ndarray] = None) -> None:
    """Both clouds in one PLY; xyz0 transformed when a pose is given (the
    before/after views of `visualization_ours`, `util/visualization.py:98-194`)."""
    p0 = apply_transform_np(xyz0, transform) if transform is not None else xyz0
    pts = np.concatenate([p0, xyz1]).astype(np.float32)
    cols = np.concatenate([np.tile(COLOR_SRC, (len(p0), 1)),
                           np.tile(COLOR_DST, (len(xyz1), 1))])
    write_ply(path, pts, colors=cols)
