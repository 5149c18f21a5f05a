"""Matching and registration: nearest neighbours (kernel B), rigid fits,
RANSAC, IRLS, ICP, metrics.

The JAX package's ``match.nn.use_pallas`` chooses its Pallas NN kernel on a
TPU and has no counterpart: here ``match.nn_kernel.flash_nn`` launches
kernel B for a CUDA tensor and runs its plain version for a CPU one."""
from imfnet_tpu_torch.match.nn import (  # noqa: F401
    blocked_nn,
    find_nn,
    mutual_nn,
    radius_match,
)
from imfnet_tpu_torch.match.procrustes import kabsch_umeyama  # noqa: F401
from imfnet_tpu_torch.match.ransac import ransac_registration  # noqa: F401
from imfnet_tpu_torch.match.irls import est_rigid_irls  # noqa: F401
from imfnet_tpu_torch.match.icp import icp_point_to_point  # noqa: F401
from imfnet_tpu_torch.match.metrics import (  # noqa: F401
    apply_transform,
    corr_dist,
    hit_ratio,
    inlier_ratio,
    pdist_sq,
    relative_rotation_error,
    relative_translation_error,
    transform_error,
)
