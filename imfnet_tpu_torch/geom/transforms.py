"""Rigid transforms and training augmentations (host-side numpy;
``imfnet_tpu.geom.transforms``: the same draws from the same ``RandomState``
in the same order).

Replaces scipy `expm`-based random rotations (`lib/data_loaders.py:94-104`)
with closed-form Rodrigues, plus the feature-jitter transform
(`lib/transforms.py:7-42`)."""
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


def sample_random_trans(
    pcd: np.ndarray, randg: np.random.RandomState, rotation_range: float = 360.0
) -> np.ndarray:
    """Random rotation about a random axis, recentered on the cloud mean
    (`lib/data_loaders.py:99-104`)."""
    axis = randg.rand(3) - 0.5
    angle = rotation_range * np.pi / 180.0 * (randg.rand(1)[0] - 0.5)
    R = axis_angle_rotation(axis, angle)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = R.dot(-np.mean(pcd, axis=0))
    return T


def apply_transform_np(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    return pts @ trans[:3, :3].T + trans[:3, 3]


class Jitter:
    """Gaussian feature jitter applied with probability p
    (`lib/transforms.py:24-36`)."""

    def __init__(self, mu=0.0, sigma=0.01, p=0.95):
        self.mu, self.sigma, self.p = mu, sigma, p

    def __call__(self, randg, coords, feats):
        if randg.rand() < self.p:
            feats = feats + self.mu + self.sigma * randg.randn(*feats.shape)
        return coords, feats


class ChromaticShift:
    """Shared RGB shift applied with probability 0.95 to the first three
    feature channels (`lib/transforms.py:33-42`; used for color-feature
    model variants)."""

    def __init__(self, mu=0.0, sigma=0.1, p=0.95):
        self.mu, self.sigma, self.p = mu, sigma, p

    def __call__(self, randg, coords, feats):
        if randg.rand() < self.p:
            feats = feats.copy()
            feats[:, :3] += self.mu + self.sigma * randg.randn(1, 3)
        return coords, feats


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, randg, coords, feats):
        for t in self.transforms:
            coords, feats = t(randg, coords, feats)
        return coords, feats
