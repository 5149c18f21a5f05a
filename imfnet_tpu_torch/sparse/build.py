"""Host-side constructors for SparseVoxels (numpy → padded, key-sorted;
``imfnet_tpu.sparse.build``)."""
from __future__ import annotations

import numpy as np
import torch

from imfnet_tpu_torch.sparse.coords import PAD_COORD, SparseVoxels


def sort_coords_np(coords: np.ndarray) -> np.ndarray:
    """Key order used by the engine: lexicographic (batch, x, y, z)."""
    return np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1], coords[:, 0]))


def from_numpy(coords: np.ndarray, feats: np.ndarray, n_pad: int,
               device=None) -> SparseVoxels:
    """A padded, key-sorted SparseVoxels from host arrays on ``device``
    (default the CPU). coords int[N,4] (batch, x, y, z) must be
    duplicate-free; feats [N,C]."""
    n = len(coords)
    assert n <= n_pad, (n, n_pad)
    order = sort_coords_np(coords)
    c = np.full((n_pad, 4), PAD_COORD, np.int32)
    c[:n] = coords[order]
    f = np.zeros((n_pad, feats.shape[1]), np.float32)
    f[:n] = feats[order]
    return SparseVoxels(torch.from_numpy(c).to(device), torch.from_numpy(f).to(device),
                        torch.tensor(n, dtype=torch.int32, device=device))
