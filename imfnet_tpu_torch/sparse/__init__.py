"""Sparse-voxel engine: coordinates and keys, quantization, kernel maps,
sparse convolution (kernel A)."""
