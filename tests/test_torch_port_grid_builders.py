"""Port parity, the pyramid builders: the port's two ``map_impl`` values,
"search" (``kernel_map.build_pyramid``) and "banded"
(``grid.build_pyramid_grid``, kernel D's plain version on the CPU), against
the JAX package's ``build_pyramid_grid`` on the inputs of
``tests/test_grid.py`` and ``tests/test_banded_map.py``, against each other
at every pyramid depth the port builds, and the refusal of the JAX
package's other builder names, which have no port counterpart. Every
output is an integer table and must be equal."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.sparse import grid as jgrid
from imfnet_tpu.sparse.build import from_numpy

from imfnet_tpu_torch.pipeline import PairRegistrar, bench_config
from imfnet_tpu_torch.sparse import grid as tgrid
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid
from imfnet_tpu_torch.train.step import MAP_IMPLS, make_pyramid_fn

from test_models import make_cloud
from test_torch_port_grid import _pyramid_tables, _t, _table


def _cloud_input(seed, sizes, span, n_pad):
    """The two-batch clouds of tests/test_grid.py, scan-ordered by
    ``build.from_numpy``."""
    rng = np.random.RandomState(seed)
    coords = np.concatenate([make_cloud(rng, n, b, span=span) for b, n in enumerate(sizes)])
    sv = from_numpy(coords, np.ones((len(coords), 1), np.float32), n_pad)
    return np.asarray(sv.coords), int(sv.num_valid)


# (name, table, valid count, extent, conv1 kernel, level capacities)
def _inputs():
    grid_k3 = _cloud_input(0, (120, 90), 10, 512)          # test_grid_pyramid_matches_search
    grid_k5 = _cloud_input(1, (400, 300), 15, 1024)        # test_transpose_pyramid_matches_packed
    banded = _table(np.random.RandomState(0), 2048, 0, 700)  # test_pyramid_banded_vs_packed
    return {
        "grid_k3": (*grid_k3, (64, 64, 64), 3, (512, 256, 128, 64)),
        "grid_k5_edge": (*grid_k5, (32, 32, 32), 5, (1024, 512, 256, 128)),
        "banded_k5": (*banded, (64, 64, 64), 5, None),
    }


INPUTS = _inputs()


@functools.lru_cache(maxsize=None)
def _jax_pyramid(name):
    """The JAX package's pyramid of one input, through its "packed" builder:
    all its builders give the same tables, and this one runs no Pallas
    kernel in interpret mode."""
    table, n, extent, k1, caps = INPUTS[name]
    spec = jgrid.GridSpec(extent=extent, num_batches=2)
    pyr = jax.jit(lambda c, nv: jgrid.build_pyramid_grid(
        c, nv, spec=spec, map_impl="packed", conv1_kernel_size=k1,
        level_capacity=caps))(jnp.asarray(table), jnp.int32(n))
    return _pyramid_tables(pyr)


def _port_pyramid(map_impl, name, num_levels=4):
    table, n, extent, k1, caps = INPUTS[name]
    if caps is not None and num_levels > len(caps):
        caps = caps + (caps[-1] // 2,) * (num_levels - len(caps))
    kw = dict(num_levels=num_levels, conv1_kernel_size=k1,
              level_capacity=None if caps is None else caps[:num_levels])
    nv = torch.tensor(n, dtype=torch.int32)
    if map_impl == "search":
        pyr = build_pyramid(_t(table), nv, **kw)
    else:
        pyr = tgrid.build_pyramid_grid(_t(table), nv, spec=tgrid.GridSpec(extent=extent),
                                       **kw)
    return _pyramid_tables(pyr)


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("map_impl", MAP_IMPLS)
def test_build_pyramid_grid_equals_jax(map_impl, name):
    got, want = _port_pyramid(map_impl, name), _jax_pyramid(name)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{map_impl} {k}")
    assert (got["up0"] >= 0).sum() > 0 and (got["k5_l0"] >= 0).sum() > 0


def test_every_builder_gives_the_search_pyramid():
    want = _port_pyramid("search", "grid_k5_edge")
    got = _port_pyramid("banded", "grid_k5_edge")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="map_impl"):
        make_pyramid_fn(bench_config(), 1024, map_impl="dense")


@pytest.mark.parametrize("num_levels", [2, 3, 5])
def test_build_pyramid_grid_equals_search_at_every_depth(num_levels):
    """Both builders at the depths other than the default 4: SimpleNet3
    builds 5 levels (``config.level_capacity_divisors``)."""
    want = _port_pyramid("search", "grid_k5_edge", num_levels)
    got = _port_pyramid("banded", "grid_k5_edge", num_levels)
    assert got.keys() == want.keys()
    assert f"coords{num_levels - 1}" in got and f"coords{num_levels}" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got[f"down{num_levels - 1}"] >= 0).sum() > 0


def test_make_pyramid_fn_passes_every_grid_builder():
    table, n = _table(np.random.RandomState(5), 2048, 0, 600)
    cfg = bench_config()
    nv = torch.tensor(n, dtype=torch.int32)
    assert MAP_IMPLS == ("search", "banded")
    want = _pyramid_tables(make_pyramid_fn(cfg, 2048, 2, extent=(64, 64, 64),
                                           map_impl="search")(_t(table), nv))
    got = _pyramid_tables(make_pyramid_fn(cfg, 2048, 2, extent=(64, 64, 64),
                                          map_impl="banded")(_t(table), nv))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("removed", ["packed", "ywide", "transpose", "auto"])
@pytest.mark.parametrize("entry", ["make_pyramid_fn", "PairRegistrar"])
def test_removed_map_impls_are_refused(entry, removed):
    """The JAX package's other builder names fail where the option is
    taken, before any pair is built."""
    with pytest.raises(ValueError, match="map_impl"):
        if entry == "make_pyramid_fn":
            make_pyramid_fn(bench_config(), 1024, extent=(64, 64, 64), map_impl=removed)
        else:
            PairRegistrar(device="cpu", map_impl=removed)
