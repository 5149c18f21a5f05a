"""Device choice, CUDA kernel builds, flax weight carry-over."""
