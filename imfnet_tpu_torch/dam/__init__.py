"""Descriptor activation maps: which input points and pixels a descriptor
rests on."""
