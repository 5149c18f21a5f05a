"""Geometry helpers (numpy): PLY and image I/O, rigid transforms,
trajectory files."""
from imfnet_tpu_torch.geom.ply import read_ply, write_ply  # noqa: F401
from imfnet_tpu_torch.geom.transforms import (  # noqa: F401
    apply_transform_np,
    axis_angle_rotation,
    sample_random_trans,
)
from imfnet_tpu_torch.geom.image import load_image, process_image  # noqa: F401
from imfnet_tpu_torch.geom.trajectory import (  # noqa: F401
    CameraPose,
    read_info_file,
    read_log,
    read_trajectory,
    write_trajectory,
)
