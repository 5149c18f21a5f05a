"""Geometry helpers (numpy)."""
