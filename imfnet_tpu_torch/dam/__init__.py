"""Descriptor activation maps: which input points and pixels a descriptor
rests on."""
from imfnet_tpu_torch.dam.dam import dam_colors, descriptor_activation_map  # noqa: F401
