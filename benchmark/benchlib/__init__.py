"""The benchmark's harness: manifest and cells, the run loop, traces,
weights from the seed, the arithmetic of the per-layer metrics, and the
comparisons that decide ``correct``."""
