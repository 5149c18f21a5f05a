"""Datasets and loaders, collation into padded batches, synthetic fragment
pairs and host-side voxel dedup (numpy)."""
from imfnet_tpu_torch.data.collate import VoxelizedPair, collate_pairs  # noqa: F401
from imfnet_tpu_torch.data.synthetic import synthetic_batch, synthetic_pair  # noqa: F401
