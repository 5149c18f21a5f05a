"""Rigid-transform helpers (numpy, host side)."""
from __future__ import annotations

import numpy as np


def axis_angle_rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues formula; equals expm(cross(eye(3), axis/|axis| * angle))."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], np.float64
    )
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)
