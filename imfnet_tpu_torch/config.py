"""Configuration: one serializable dataclass with dataset presets, the
fields, defaults and field order of ``imfnet_tpu.config.Config`` (the
reference's `config_3dmatch.py:18-143` and `config_kitti.py`), so that
``to_json()`` of the two defaults is the same string and a ``config.json``
or a checkpoint's ``meta.json`` written by either package loads in the
other. The config is written into the run directory and embedded in
checkpoints (`lib/trainer.py:87-91`)."""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    # --- trainer (reference: config_3dmatch.py:21-36) ---
    trainer: str = "HardestContrastiveLossTrainer"
    batch_size: int = 2
    val_batch_size: int = 1
    num_pos_per_batch: int = 1024
    num_hn_samples_per_batch: int = 256
    neg_thresh: float = 1.4
    pos_thresh: float = 0.1
    neg_weight: float = 1.0

    # --- augmentation (config_3dmatch.py:39-43) ---
    use_random_scale: bool = False
    min_scale: float = 0.8
    max_scale: float = 1.2
    use_random_rotation: bool = True
    rotation_range: float = 360.0

    # --- validation (config_3dmatch.py:50-57) ---
    stat_freq: int = 40
    test_valid: bool = True
    val_max_iter: int = 400
    val_epoch_freq: int = 1
    positive_pair_search_voxel_size_multiplier: float = 1.5
    hit_ratio_thresh: float = 0.1

    # --- triplet losses (config_3dmatch.py:60-62) ---
    triplet_num_pos: int = 256
    triplet_num_hn: int = 512
    triplet_num_rand: int = 1024

    # --- network (config_3dmatch.py:66-71) ---
    model: str = "ResUNetBN2C"
    model_n_out: int = 32
    conv1_kernel_size: int = 5
    normalize_feature: bool = True
    dist_type: str = "L2"
    best_val_metric: str = "feat_match_ratio"
    in_channels: int = 1

    # --- optimizer (config_3dmatch.py:75-87) ---
    optimizer: str = "SGD"
    max_epoch: int = 200
    lr: float = 1e-1
    momentum: float = 0.8
    weight_decay: float = 1e-4
    iter_size: int = 1
    bn_momentum: float = 0.05
    exp_gamma: float = 0.99

    # --- data (config_3dmatch.py:117-143) ---
    dataset: str = "ThreeDMatchPairDataset"
    voxel_size: float = 0.025
    threed_match_dir: str = ""
    overlap_path: str = ""
    kitti_root: str = ""
    kitti_max_time_diff: int = 3
    kitti_date: str = "2020_09_30"
    icp_cache_path: str = ""
    image_W: int = 160
    image_H: int = 120

    # --- eval (scripts/evaluation_3dmatch.py:28-32,580; benchmark_util.py:16-34) ---
    num_rand_keypoints: int = 5000
    # replay persisted per-pair keypoint indices instead of sampling
    # (the reference's cfg.keypoints, `evaluation_3dmatch.py:146-151`)
    use_saved_keypoints: bool = False
    inlier_thresh: float = 0.1
    fmr_inlier_ratio_threshes: Tuple[float, ...] = (0.05, 0.20)
    ransac_n: int = 3
    ransac_max_iteration: int = 50000
    ransac_edge_length_ratio: float = 0.9
    # NN chunk size (result-invariant): the reference's GPU-memory knob
    # (`lib/eval.py:18-48`, default 500)
    nn_max_n: int = 4096
    # validation subsample (`lib/trainer.py:419` hardcodes 5000)
    val_subsample_size: int = 5000

    # --- static padded sizes of the sparse engine (no reference equivalent) ---
    # Variable point counts are padded to these shapes (per concatenated
    # batch side).
    max_points: int = 65536           # stride-1 voxels per batch side
    max_correspondences: int = 16384  # positive pairs per batch
    # Grid pyramid (kernel maps from packed word tables) in a static extent
    # of stride-1 voxel cells per fragment; False takes the search pyramid,
    # which needs no extent.
    use_grid_maps: bool = True
    grid_extent: Tuple[int, int, int] = (256, 256, 256)
    # Additional smaller extents for extraction: the extractor probes each
    # fragment's voxel span on the host and runs the smallest extent bucket
    # that holds it; entries >= grid_extent are ignored
    # (eval.extract.extent_buckets). Training always uses grid_extent.
    grid_extent_buckets: Optional[Tuple[Tuple[int, int, int], ...]] = None
    # Static per-UNet-level row capacities: level i holds max_points //
    # divisor[i]. Surface data shrinks ~3.4x per stride-2; (1,2,4,8) is the
    # safe default, (1,3,8,20) fits 3DMatch fragments with margin.
    level_capacity_divisors: Tuple[int, int, int, int] = (1, 2, 4, 8)
    compute_dtype: str = "bfloat16"   # conv/attention compute dtype (f32 accum)
    param_dtype: str = "float32"
    # Data parallelism over the pair axis: 1 = one device; 0 = auto, which
    # is one device as well while the port runs on one card; anything else
    # raises in the Trainer until data parallelism is ported.
    data_parallel: int = 1
    # SyntheticPairDataset size knobs (smoke training / CI; not in the
    # reference): pairs per epoch and raw points per fragment
    synthetic_length: int = 64
    synthetic_n_points: int = 4000
    seed: int = 0
    out_dir: str = "outputs"
    save_freq_epoch: int = 1
    resume: Optional[str] = None
    weights: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=False)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        """Unknown keys are dropped (a config written by a later version
        still loads) and JSON lists become the dataclass's tuples again."""
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        for k in ("fmr_inlier_ratio_threshes", "grid_extent", "grid_extent_buckets",
                  "level_capacity_divisors"):
            if d.get(k) is not None:
                d[k] = _as_tuple(d[k])
        return cls(**d)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _as_tuple(v):
    """JSON lists back to the (nested) tuples of the dataclass."""
    return tuple(_as_tuple(x) for x in v) if isinstance(v, (list, tuple)) else v


def threedmatch_config(**overrides) -> Config:
    """Defaults of the reference's `config_3dmatch.py`."""
    return Config(**overrides)


def kitti_config(**overrides) -> Config:
    """Deltas of the reference's `config_kitti.py` vs 3DMatch: voxel 0.3,
    random_scale on, hit_ratio 0.3, best_val 'success', KITTINMPairDataset,
    ransac_n=4 (`scripts/evaluation_kitti.py:99-112`)."""
    base = dict(
        dataset="KITTINMPairDataset",
        voxel_size=0.3,
        use_random_scale=True,
        hit_ratio_thresh=0.3,
        best_val_metric="success",
        ransac_n=4,
        out_dir="outputs_kitti",
        max_points=131072,
        grid_extent=(704, 704, 128),
        # velodyne scans span most of the static range: a half-extent
        # bucket would almost never fit
        grid_extent_buckets=None,
        # velodyne scans are thin and sparse: coarse levels shrink far more
        # slowly than indoor surface data, so per-level capacities must stay
        # generous (overflow silently drops coarse voxels)
        level_capacity_divisors=(1, 1, 2, 4),
    )
    base.update(overrides)
    return Config(**base)


def dgr_kitti_config(**overrides) -> Config:
    """Deep Global Registration's inlier network on KITTI scan pairs
    (``eval.dgr``): KITTI's voxel 0.3 and 131 072 rows a side, and the
    network's own settings in the fields that hold them: ResUNetBN2C with
    conv1 k3 (DGR's ``inlier_conv1_kernel_size``), one output logit, no
    feature normalization. Its correspondences do not shrink as 3-D scans
    do when coarsened (outliers never merge), so every level keeps the
    whole padded capacity."""
    base = dict(conv1_kernel_size=3, model_n_out=1, normalize_feature=False,
                level_capacity_divisors=(1, 1, 1, 1))
    base.update(overrides)
    return kitti_config(**base)
