"""Host-side pair counting (``imfnet_tpu.utils.native.count_pairs_within_radius``,
its scipy path). The JAX package's ctypes loader of the native helper
library is not ported."""
from __future__ import annotations

import numpy as np


def count_pairs_within_radius(src: np.ndarray, dst: np.ndarray,
                              radius: float) -> int:
    """Total (i, j) pairs with |src_i - dst_j| <= radius: the statistic
    `len(get_matching_indices(...))` measures (`util/pointcloud.py:56-69`),
    used by the KITTI <1000-match pair rejection
    (`lib/data_loaders.py:586-588`)."""
    if len(src) == 0 or len(dst) == 0:
        return 0
    from scipy.spatial import cKDTree

    tree = cKDTree(dst)
    return int(np.sum(tree.query_ball_point(src, radius, return_length=True)))
