"""Pieces of the JAX package's train/ that the inference slice needs."""
