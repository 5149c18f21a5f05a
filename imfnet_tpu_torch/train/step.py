"""Per-config pyramid construction (``imfnet_tpu.train.step:53-106``).

The training step itself belongs to a later slice of the port."""
from __future__ import annotations

from typing import Tuple

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid


def level_capacities(
    n_pad: int, divisors: Tuple[int, ...] = (1, 2, 4, 8)
) -> Tuple[int, ...]:
    """Static per-level row capacities: level i holds ``n_pad // divisor[i]``
    rows (at least 256)."""
    return tuple(max(n_pad // d, 256) for d in divisors)


def make_pyramid_fn(config: Config, n_pad: int):
    """fn(coords, num_valid) → CoordinatePyramid at this config's level
    capacities. The JAX package picks between a packed-grid and a search
    builder here; their tables are equal, and the port has the one exact
    builder."""
    caps = level_capacities(n_pad, tuple(config.level_capacity_divisors))

    def fn(coords, n):
        return build_pyramid(coords, n,
                             conv1_kernel_size=config.conv1_kernel_size,
                             level_capacity=caps)

    return fn
