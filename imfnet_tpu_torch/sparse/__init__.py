"""Sparse-voxel engine: coordinates and keys, quantization, kernel maps,
sparse convolution (kernel A)."""
from imfnet_tpu_torch.sparse.coords import (  # noqa: F401
    SparseVoxels,
    lookup,
    make_keys,
    stride_coords,
    unique_voxels,
)
from imfnet_tpu_torch.sparse.kernel_map import (  # noqa: F401
    CoordinatePyramid,
    build_pyramid,
    kernel_map_down,
    kernel_map_same,
    kernel_map_up,
    kernel_offsets,
)
from imfnet_tpu_torch.sparse.ops import (  # noqa: F401
    masked_batchnorm_stats,
    row_mask,
    sparse_cat,
    sparse_conv,
)
