"""Port parity, the other grid map builders: every ``map_impl`` of
``build_pyramid_grid`` ("packed", "banded", "ywide", "transpose", "auto")
against the JAX package's ``build_pyramid_grid`` with the same
``map_impl``, on the inputs of ``tests/test_grid.py`` and
``tests/test_banded_map.py``, and the builders' parts (the unpacked row
grid, ``scan_position``, ``widen_y``, the y-widened, symmetric and
scatter-transposed maps) against their JAX functions. Every output is an
integer table and must be equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.sparse import grid as jgrid
from imfnet_tpu.sparse.build import from_numpy

from imfnet_tpu_torch.pipeline import bench_config
from imfnet_tpu_torch.sparse import grid as tgrid
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid
from imfnet_tpu_torch.train.step import MAP_IMPLS, make_pyramid_fn

from test_models import make_cloud
from test_torch_port_grid import MAP_CASES, _map_case, _pyramid_tables, _t, _table

IMPLS = ("packed", "banded", "ywide", "transpose")


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


# the dense builders on the two conv1 k5 inputs, "banded" (the JAX side runs
# its Pallas matcher in interpret mode, 9 s a pyramid) on one, and "auto" on
# the conv1 k3 input
PYRAMID_CASES = ([(impl, name) for impl in ("packed", "ywide", "transpose")
                  for name in ("banded_k5", "grid_k5_edge")]
                 + [("banded", "banded_k5"), ("auto", "grid_k3")])


@pytest.mark.parametrize("map_impl,name", PYRAMID_CASES)
def test_build_pyramid_grid_equals_jax(map_impl, name):
    table, n, extent, k1, caps = INPUTS[name]
    kw = dict(conv1_kernel_size=k1, level_capacity=caps)
    spec_j = jgrid.GridSpec(extent=extent, num_batches=2)
    spec_t = tgrid.GridSpec(extent=extent, num_batches=2)
    # "auto" is "ywide" in the JAX package and "banded" in the port: the
    # tables are equal either way
    pyr_j = jax.jit(lambda c, nv: jgrid.build_pyramid_grid(
        c, nv, spec=spec_j, map_impl=map_impl, **kw))(jnp.asarray(table), jnp.int32(n))
    pyr_t = tgrid.build_pyramid_grid(_t(table), torch.tensor(n, dtype=torch.int32),
                                     spec=spec_t, map_impl=map_impl, **kw)
    got, want = _pyramid_tables(pyr_t), _pyramid_tables(pyr_j)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{map_impl} {k}")
    assert (got["up0"] >= 0).sum() > 0 and (got["k5_l0"] >= 0).sum() > 0


def test_every_builder_gives_the_search_pyramid():
    table, n, extent, k1, caps = INPUTS["grid_k5_edge"]
    nv = torch.tensor(n, dtype=torch.int32)
    want = _pyramid_tables(build_pyramid(_t(table), nv, conv1_kernel_size=k1,
                                         level_capacity=caps))
    for impl in IMPLS:
        got = _pyramid_tables(tgrid.build_pyramid_grid(
            _t(table), nv, spec=tgrid.GridSpec(extent=extent), conv1_kernel_size=k1,
            level_capacity=caps, map_impl=impl))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{impl} {k}")
    with pytest.raises(ValueError, match="map_impl"):
        tgrid.build_pyramid_grid(_t(table), nv, spec=tgrid.GridSpec(extent=extent),
                                 map_impl="dense")


def test_make_pyramid_fn_passes_every_grid_builder():
    table, n = _table(np.random.RandomState(5), 2048, 0, 600)
    cfg = bench_config()
    nv = torch.tensor(n, dtype=torch.int32)
    assert set(MAP_IMPLS) == {"search", "auto", "banded", "packed", "ywide", "transpose"}
    want = _pyramid_tables(make_pyramid_fn(cfg, 2048, 2, extent=(64, 64, 64),
                                           map_impl="search")(_t(table), nv))
    for impl in MAP_IMPLS[1:]:
        got = _pyramid_tables(make_pyramid_fn(cfg, 2048, 2, extent=(64, 64, 64),
                                              map_impl=impl)(_t(table), nv))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{impl} {k}")


def _level_args(case):
    return (_t(case["tab"]), _t(case["tv"]), _t(case["origins"]))


@pytest.mark.parametrize("lvl", [0, 1])
def test_row_grid_and_lookup_equal_jax(lvl):
    case = _map_case(lvl, 3, "same")
    spec_j = jgrid.GridSpec(extent=(64, 64, 64), num_batches=2)
    spec_t = tgrid.GridSpec(extent=(64, 64, 64), num_batches=2)
    tab, tv, origins = case["tab"], case["tv"], case["origins"]
    g_j = jgrid.build_grid(jnp.asarray(tab), jnp.asarray(tv), jnp.asarray(origins), spec_j, lvl)
    g_t = tgrid.build_grid(*_level_args(case), spec_t, lvl)
    assert g_t.dtype == torch.int32
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    # every row finds itself; shifted and off-lattice queries as JAX's
    rng = np.random.RandomState(lvl)
    queries = tab.copy()
    queries[:, 1:] += rng.randint(-2, 3, (len(tab), 3)) * (1 << lvl)
    queries[::7, 3] += 1
    for q in (tab, queries):
        for align in (False, True):
            want = jgrid.grid_lookup(g_j, jnp.asarray(origins), jnp.asarray(q), jnp.asarray(tv),
                                     spec_j, lvl, check_alignment=align)
            got = tgrid.grid_lookup(g_t, _t(origins), _t(q), _t(tv), spec_t, lvl,
                                    check_alignment=align)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = int(tv.sum())
    hit = tgrid.grid_lookup(g_t, _t(origins), _t(tab), _t(tv), spec_t, lvl).numpy()
    np.testing.assert_array_equal(hit[:n], np.arange(n))
    offsets = np.array([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dz in (-1, 0, 1)]) * (1 << lvl)
    want = jgrid._offset_map(g_j, jnp.asarray(origins), jnp.asarray(tab), jnp.asarray(tv),
                             offsets, spec_j, lvl)
    got = tgrid._offset_map(g_t, _t(origins), _t(tab), _t(tv), offsets, spec_t, lvl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), case["nbr"])


@pytest.mark.parametrize("lvl", [0, 2])
def test_scan_position_equals_jax(lvl):
    case = _map_case(lvl, 3, "same")
    spec_j = jgrid.GridSpec(extent=(64, 64, 64), num_batches=2)
    spec_t = tgrid.GridSpec(extent=(64, 64, 64), num_batches=2)
    args_j = (jnp.asarray(case["tab"]), jnp.asarray(case["tv"]), jnp.asarray(case["origins"]))
    bits_j, rank_j = jgrid.pack_words(*args_j, spec_j, lvl)
    bits_t, rank_t = tgrid.pack_words(*_level_args(case), spec_t, lvl)
    # queries: the table itself, a shifted copy and some rows outside the extent
    q = case["tab"].copy()
    q[1::3, 2] += 1 << lvl
    q[::11, 1] += 1000
    qv = case["tv"]
    want = jgrid.scan_position(bits_j, rank_j, jnp.asarray(q), jnp.asarray(qv),
                               jnp.asarray(case["origins"]), spec_j, lvl)
    got = tgrid.scan_position(bits_t, rank_t, _t(q), _t(qv), _t(case["origins"]), spec_t, lvl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = int(qv.sum())
    self_pos = tgrid.scan_position(bits_t, rank_t, *_level_args(case), spec_t, lvl).numpy()
    np.testing.assert_array_equal(self_pos[:n], np.arange(n))


@pytest.mark.parametrize("r", [1, 2])
def test_widen_y_equals_jax(r):
    case = _map_case(0, 3, "same")
    spec_j = jgrid.GridSpec(extent=(64, 64, 64), num_batches=2)
    spec_t = tgrid.GridSpec(extent=(64, 64, 64), num_batches=2)
    pj = jgrid.pack_level(jnp.asarray(case["tab"]), jnp.asarray(case["tv"]),
                          jnp.asarray(case["origins"]), spec_j, 0)
    pt = tgrid.pack_level(*_level_args(case), spec_t, 0)
    got = tgrid.widen_y(pt, r)
    assert got.shape == (pt.table.shape[0], 4 * (2 * r + 1)) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgrid.widen_y(pj, r)))


# of the (level, kernel, mode) cases of tests/test_banded_map.py: the
# y-widened map of one of each mode (build_pyramid_grid's cases above hold
# every other), the symmetric map of two 'same' ones, the transposed map of
# the 'up' ones
BUILDER_CASES = ([("ywide", 0, 5, "same"), ("ywide", 1, 3, "down"), ("ywide", 2, 3, "up"),
                  ("sym", 0, 5, "same"), ("sym", 1, 3, "same")]
                 + [("transpose", *c) for c in MAP_CASES if c[2] == "up"])


@pytest.mark.parametrize("builder,lvl,kernel,mode", BUILDER_CASES)
def test_offset_maps_equal_jax(builder, lvl, kernel, mode):
    """Each builder's map of one (level, kernel, mode) case against the JAX
    function and the packed map (``transpose_offset_map`` of the 'down' map
    of the coarser level)."""
    case = _map_case(lvl, kernel, mode)
    spec_j = jgrid.GridSpec(extent=(64, 64, 64), num_batches=2)
    spec_t = tgrid.GridSpec(extent=(64, 64, 64), num_batches=2)
    tab_j, tv_j, o_j = (jnp.asarray(case[k]) for k in ("tab", "tv", "origins"))
    tab, tv, origins = _level_args(case)
    qc, qv = case["qc"], case["qv"]
    kw = dict(table_level=lvl, kernel_size=kernel)
    pj = jgrid.pack_level(tab_j, tv_j, o_j, spec_j, lvl)
    pt = tgrid.pack_level(tab, tv, origins, spec_t, lvl)
    if builder == "ywide":
        rw = max(kernel // 2, 1)
        want = jgrid.packed_offset_map_ywide(pj, jgrid.widen_y(pj, rw), o_j, jnp.asarray(qc),
                                             jnp.asarray(qv), spec_j, mode=mode, **kw)
        got = tgrid.packed_offset_map_ywide(pt, tgrid.widen_y(pt, rw), origins, _t(qc),
                                            _t(qv), spec_t, mode=mode, **kw)
    elif builder == "sym":
        want = jgrid.packed_offset_map_sym(pj, o_j, jnp.asarray(qc), jnp.asarray(qv),
                                           spec_j, **kw)
        got = tgrid.packed_offset_map_sym(pt, origins, _t(qc), _t(qv), spec_t, **kw)
    else:
        # the 'down' map from the fine queries' level to this table's level,
        # built on the swapped roles: queries at lvl gather from lvl - 1
        down_j = jgrid.packed_offset_map(
            jgrid.pack_level(jnp.asarray(qc), jnp.asarray(qv), o_j, spec_j, lvl - 1),
            o_j, tab_j, tv_j, spec_j, table_level=lvl - 1, kernel_size=3, mode="down")
        want = jgrid.transpose_offset_map(down_j, qc.shape[0])
        got = tgrid.transpose_offset_map(_t(np.asarray(down_j)), qc.shape[0])
    assert got.dtype == torch.int32 and got.shape == (len(qc), kernel ** 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), case["nbr"])


def test_scatter_inverse_equals_jax():
    rng = np.random.RandomState(9)
    n_rows, q_n, c_n = 50, 40, 6
    # an injective block: each target row at most once per column, -1 elsewhere
    src = np.full((q_n, c_n), -1, np.int32)
    for c in range(c_n):
        rows = rng.choice(n_rows, q_n, replace=False)
        keep = rng.rand(q_n) < 0.6
        src[keep, c] = rows[keep]
    want = np.asarray(jgrid._scatter_inverse(jnp.asarray(src), n_rows))
    got = tgrid._scatter_inverse(_t(src), n_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    # inv[src[q, C-1-j], j] = q
    for q in range(q_n):
        for j in range(c_n):
            p = src[q, c_n - 1 - j]
            if p >= 0:
                assert got[p, j] == q
