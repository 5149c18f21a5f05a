"""Configuration: the fields of ``imfnet_tpu.config.Config`` that the
fragment-pair registration slice reads, with the same names and defaults
(the reference's `config_3dmatch.py`)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    # --- network (config_3dmatch.py:66-71) ---
    model: str = "ResUNetBN2C"
    model_n_out: int = 32
    conv1_kernel_size: int = 5
    normalize_feature: bool = True
    in_channels: int = 1

    # --- data (config_3dmatch.py:117-143) ---
    voxel_size: float = 0.025
    image_W: int = 160
    image_H: int = 120

    # --- eval (scripts/evaluation_3dmatch.py:28-32,580) ---
    num_rand_keypoints: int = 5000
    inlier_thresh: float = 0.1
    ransac_n: int = 3
    ransac_max_iteration: int = 50000

    # --- static padded sizes of the sparse engine ---
    use_grid_maps: bool = True
    grid_extent: Tuple[int, int, int] = (256, 256, 256)
    grid_extent_buckets: Optional[Tuple[Tuple[int, int, int], ...]] = None
    level_capacity_divisors: Tuple[int, int, int, int] = (1, 2, 4, 8)
    compute_dtype: str = "bfloat16"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def threedmatch_config(**overrides) -> Config:
    """Defaults of the reference's `config_3dmatch.py`."""
    return Config(**overrides)
