"""Matching and registration: nearest neighbours (kernel B), rigid fits,
RANSAC, metrics."""
