"""Synthetic fragment pairs and host-side voxel dedup (numpy)."""
