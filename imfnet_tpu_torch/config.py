"""Configuration: the fields of ``imfnet_tpu.config.Config`` that the port
reads (fragment-pair registration, the training and the validation step),
with the same names and defaults (the reference's `config_3dmatch.py`)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    # --- trainer (config_3dmatch.py:21-36) ---
    trainer: str = "HardestContrastiveLossTrainer"
    batch_size: int = 2
    num_pos_per_batch: int = 1024
    num_hn_samples_per_batch: int = 256
    neg_thresh: float = 1.4
    pos_thresh: float = 0.1
    neg_weight: float = 1.0

    # --- validation (config_3dmatch.py:50-57) ---
    positive_pair_search_voxel_size_multiplier: float = 1.5
    hit_ratio_thresh: float = 0.1
    val_subsample_size: int = 5000

    # --- triplet losses (config_3dmatch.py:60-62) ---
    triplet_num_pos: int = 256
    triplet_num_hn: int = 512
    triplet_num_rand: int = 1024

    # --- optimizer (config_3dmatch.py:75-87) ---
    optimizer: str = "SGD"
    lr: float = 1e-1
    momentum: float = 0.8
    weight_decay: float = 1e-4
    iter_size: int = 1
    bn_momentum: float = 0.05
    exp_gamma: float = 0.99

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
    max_points: int = 65536           # stride-1 voxels per batch side
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
