"""Per-config pyramid construction (``imfnet_tpu.train.step:53-106``).

The training step itself belongs to a later slice of the port."""
from __future__ import annotations

from typing import Tuple

from imfnet_tpu_torch.config import Config
from imfnet_tpu_torch.sparse.grid import GridSpec, build_pyramid_grid
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid

MAP_IMPLS = ("search", "banded")


def level_capacities(
    n_pad: int, divisors: Tuple[int, ...] = (1, 2, 4, 8)
) -> Tuple[int, ...]:
    """Static per-level row capacities: level i holds ``n_pad // divisor[i]``
    rows (at least 256)."""
    return tuple(max(n_pad // d, 256) for d in divisors)


def make_pyramid_fn(config: Config, n_pad: int, num_batches: int = 2,
                    extent: Tuple[int, int, int] | None = None,
                    map_impl: str = "search"):
    """fn(coords, num_valid) → CoordinatePyramid at this config's level
    capacities.

    ``map_impl`` picks the builder; both give the same tables for
    in-extent inputs:
    - "search": sort + ``torch.searchsorted`` (``kernel_map.build_pyramid``),
      which needs no extent;
    - "banded": ``grid.build_pyramid_grid`` on compact word tables through
      kernel D, in the static extent ``extent`` (default
      ``config.grid_extent``) for ``num_batches`` batches, as the JAX
      package's ``use_grid``/``extent`` do.
    The dense "packed" grid builder is the banded maps' oracle and stays a
    ``build_pyramid_grid`` option only."""
    if map_impl not in MAP_IMPLS:
        raise ValueError(f"make_pyramid_fn: map_impl must be one of {MAP_IMPLS}, "
                         f"got {map_impl!r}")
    caps = level_capacities(n_pad, tuple(config.level_capacity_divisors))
    if map_impl == "search":
        def fn(coords, n):
            return build_pyramid(coords, n,
                                 conv1_kernel_size=config.conv1_kernel_size,
                                 level_capacity=caps)
        return fn

    spec = GridSpec(extent=tuple(extent if extent is not None else config.grid_extent),
                    num_batches=num_batches)

    def fn(coords, n):
        return build_pyramid_grid(coords, n, spec=spec,
                                  conv1_kernel_size=config.conv1_kernel_size,
                                  level_capacity=caps, map_impl=map_impl)

    return fn
