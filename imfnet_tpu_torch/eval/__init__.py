"""Pair registration and the host helpers that pick extraction shapes."""
