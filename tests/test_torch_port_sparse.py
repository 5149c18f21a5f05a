"""Port parity, sparse engine: quantization, coordinate pyramid, sparse-conv
plain version, against the JAX package on the same numpy inputs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.sparse import grid as jgrid
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.sparse import ops as jops
from imfnet_tpu.sparse.ops import sparse_conv as jax_sparse_conv
from imfnet_tpu.sparse.pallas_conv import (banded_conv_pallas,
                                           banded_conv_pallas_union,
                                           plan_windows_union)
from imfnet_tpu.train.step import make_pyramid_fn as jax_make_pyramid_fn

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.sparse.conv_kernel import gather_gemm, gather_gemm_plain
from imfnet_tpu_torch.sparse.grid import GridSpec, quantize_grid
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid, coarse_levels_fit
from imfnet_tpu_torch.sparse.ops import (masked_batchnorm_stats,
                                          masked_instancenorm, sparse_conv)
from imfnet_tpu_torch.train.step import level_capacities, make_pyramid_fn

VOXEL = 0.025
CAPS = (512, 256, 128, 64)


def _raw_points(seed, n=1500, span=0.45):
    """Two batches of surface-ish raw points with many per voxel, some
    invalid rows and some outside a 16-cell extent."""
    rng = np.random.RandomState(seed)
    xyz = np.empty((n, 3), np.float32)
    half = n // 2
    for b, sl in enumerate((slice(0, half), slice(half, n))):
        m = sl.stop - sl.start
        t = rng.rand(m, 2) * span
        xyz[sl, 0] = t[:, 0] + 0.3 * b
        xyz[sl, 1] = t[:, 1] - 0.2
        xyz[sl, 2] = 0.1 * np.sin(7 * t[:, 0]) + rng.randn(m) * 0.01
    batch = (np.arange(n) >= half).astype(np.int32)
    valid = rng.rand(n) > 0.1
    return xyz, batch, valid


def _quantize_both(xyz, batch, valid, n_out, extent):
    ones = np.ones((len(xyz), 1), np.float32)
    sv_j, sel_j, xd_j = jgrid.quantize_grid(
        jnp.asarray(xyz), jnp.asarray(ones), jnp.asarray(valid), VOXEL, n_out,
        jgrid.GridSpec(extent=extent, num_batches=2),
        batch_index=jnp.asarray(batch))
    sv_t, sel_t, xd_t = quantize_grid(
        torch.from_numpy(xyz), torch.from_numpy(ones), torch.from_numpy(valid),
        VOXEL, n_out, GridSpec(extent=extent, num_batches=2),
        batch_index=torch.from_numpy(batch))
    return (sv_j, sel_j, xd_j), (sv_t, sel_t, xd_t)


@pytest.mark.parametrize("n_out,extent", [
    (1024, (64, 64, 64)),   # fits
    (100, (64, 64, 64)),    # capacity overflow: first 100 in scan order
    (4096, (64, 64, 64)),   # capacity above the raw row count
    (1024, (12, 16, 6)),    # points outside the extent are dropped
])
def test_quantize_grid_exact(n_out, extent):
    xyz, batch, valid = _raw_points(0)
    (sv_j, sel_j, xd_j), (sv_t, sel_t, xd_t) = _quantize_both(
        xyz, batch, valid, n_out, extent)
    assert int(sv_t.num_valid) == int(sv_j.num_valid)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(sv_t.coords.numpy(), np.asarray(sv_j.coords))
    np.testing.assert_array_equal(sv_t.feats.numpy(), np.asarray(sv_j.feats))
    np.testing.assert_array_equal(xd_t.numpy(), np.asarray(xd_j))
    if n_out == 100:
        assert int(sv_t.num_valid) == 100


def _pyramid_input(seed=0):
    xyz, batch, valid = _raw_points(seed)
    (sv_j, _, _), (sv_t, _, _) = _quantize_both(xyz, batch, valid, CAPS[0],
                                                (64, 64, 64))
    return sv_j, sv_t


def _assert_pyramids_equal(pyr_t, pyr_j):
    np.testing.assert_array_equal(pyr_t.k5_l0.numpy(), np.asarray(pyr_j.k5_l0))
    for lt, lj in zip(pyr_t.levels, pyr_j.levels):
        assert int(lt.num_valid) == int(lj.num_valid)
        np.testing.assert_array_equal(lt.coords.numpy(), np.asarray(lj.coords))
        np.testing.assert_array_equal(lt.k3_same.numpy(), np.asarray(lj.k3_same))
        for which in ("down", "up"):
            a, b = getattr(lt, which), getattr(lj, which)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("conv1_kernel_size,caps", [
    (3, CAPS), (5, CAPS),
    (5, (512, 64, 16, 8)),   # coarse levels clamped at capacity
])
def test_pyramid_equals_search_builder(conv1_kernel_size, caps):
    sv_j, sv_t = _pyramid_input()
    pyr_j = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, conv1_kernel_size=conv1_kernel_size, level_capacity=caps))(
        sv_j.coords, sv_j.num_valid)
    pyr_t = build_pyramid(sv_t.coords, sv_t.num_valid,
                          conv1_kernel_size=conv1_kernel_size,
                          level_capacity=caps)
    _assert_pyramids_equal(pyr_t, pyr_j)
    if caps[1] == 64:
        assert not bool(coarse_levels_fit(pyr_t))


@pytest.mark.parametrize("divisors", [(1, 3, 8, 20), (1, 2, 4, 8)])
def test_pyramid_equals_grid_builder(divisors):
    """make_pyramid_fn equals the JAX grid builder (use_grid=True)."""
    sv_j, sv_t = _pyramid_input(1)
    n_pad = CAPS[0]
    jcfg = jax_config(level_capacity_divisors=divisors)
    pyr_j = jax.jit(jax_make_pyramid_fn(jcfg, n_pad, 2, use_grid=True,
                                        extent=(64, 64, 64)))(sv_j.coords,
                                                              sv_j.num_valid)
    cfg = threedmatch_config(level_capacity_divisors=divisors)
    pyr_t = make_pyramid_fn(cfg, n_pad)(sv_t.coords, sv_t.num_valid)
    _assert_pyramids_equal(pyr_t, pyr_j)
    assert level_capacities(n_pad, divisors) == tuple(
        lv.coords.shape[0] for lv in pyr_t.levels)
    fits = all(int(lv.num_valid) < lv.coords.shape[0] for lv in pyr_t.levels[1:])
    assert bool(coarse_levels_fit(pyr_t)) == fits


@pytest.fixture(scope="module")
def maps():
    """Real kernel maps of a small two-fragment pyramid, as numpy."""
    _, sv_t = _pyramid_input(2)
    pyr = build_pyramid(sv_t.coords, sv_t.num_valid, level_capacity=CAPS)
    return pyr


# the ten (mode, cin, cout) conv shapes of the main path, with the map each
# runs on: (level, map name)
MAIN_PATH_CONVS = [
    ("same", 32, 32, 0, "k3_same"), ("same", 64, 64, 1, "k3_same"),
    ("same", 128, 128, 2, "k3_same"), ("same", 256, 256, 3, "k3_same"),
    ("down", 32, 64, 1, "down"), ("down", 64, 128, 2, "down"),
    ("down", 128, 256, 3, "down"),
    ("up", 256, 128, 2, "up"), ("up", 256, 64, 1, "up"), ("up", 128, 64, 0, "up"),
]


def _conv_inputs(pyr, level, which, cin, cout, seed):
    nbr = getattr(pyr.levels[level], which).numpy()
    src = {"k3_same": level, "down": level - 1, "up": level + 1}[which]
    n_in = pyr.levels[src].coords.shape[0]
    rng = np.random.RandomState(seed)
    x = rng.randn(n_in, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) * (27 * cin) ** -0.5).astype(np.float32)
    return x, nbr, w


@pytest.mark.parametrize("mode,cin,cout,level,which", MAIN_PATH_CONVS,
                         ids=[f"{m}-{a}-{b}" for m, a, b, _, _ in MAIN_PATH_CONVS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_conv_matches_jax(maps, mode, cin, cout, level, which, dtype):
    """f32: the same sums in another order, atol 1e-4. bf16: the JAX CPU
    strategy for cout < cin (mul-first) rounds each of the K per-offset
    partial products to bf16 before summing (2^-9 relative each), so the
    tolerance is 1e-2 of the output's scale."""
    x, nbr, w = _conv_inputs(maps, level, which, cin, cout, seed=cin + cout)
    mask = np.arange(nbr.shape[0]) < int(maps.levels[level].num_valid)
    bias = np.linspace(-1, 1, cout).astype(np.float32)
    ref = np.asarray(jax_sparse_conv(
        jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w), bias=jnp.asarray(bias),
        out_mask=jnp.asarray(mask), compute_dtype=getattr(jnp, dtype),
        z_adjacent=True))
    out = sparse_conv(torch.from_numpy(x), torch.from_numpy(nbr),
                      torch.from_numpy(w), bias=torch.from_numpy(bias),
                      out_mask=torch.from_numpy(mask),
                      compute_dtype=getattr(torch, dtype)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    atol = 1e-4 if dtype == "float32" else 1e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    assert (out[~mask] == 0).all()


def test_plain_matches_pallas_union_kernel(maps):
    """Plain version vs the TPU union kernel (interpret mode) on the
    same-128 map, a union-planned shape (ops._BAND_PLANS)."""
    x, nbr, w = _conv_inputs(maps, 2, "k3_same", 128, 128, seed=3)
    n_out, n_in = nbr.shape[0], x.shape[0]
    block, width = 64, -(-n_in // 8) * 8 + 8
    nbr_p, starts, exact = plan_windows_union(jnp.asarray(nbr), width, n_in,
                                              block=block)
    assert bool(exact)
    ref = banded_conv_pallas_union(jnp.asarray(x), nbr_p, starts, jnp.asarray(w),
                                   n_out, block=block, width=width,
                                   interpret=True)
    out = gather_gemm_plain(torch.from_numpy(x), torch.from_numpy(nbr),
                            torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_plain_matches_pallas_planned_kernel(maps):
    """Plain version vs the TPU planned kernel (interpret mode) on the
    same-32 map with lane packing, as ops._BAND_PLANS plans it."""
    x, nbr, w = _conv_inputs(maps, 0, "k3_same", 32, 32, seed=4)
    n_in = x.shape[0]
    ref, exact = banded_conv_pallas(jnp.asarray(x), jnp.asarray(nbr),
                                    jnp.asarray(w), kz=3, block=128,
                                    width=n_in // 4 + 8, pack=4,
                                    interpret=True)
    assert bool(exact)
    out = gather_gemm_plain(torch.from_numpy(x), torch.from_numpy(nbr),
                            torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dead_rows_are_exact_zeros(maps, dtype):
    x, nbr, w = _conv_inputs(maps, 1, "k3_same", 64, 64, seed=5)
    nbr = nbr.copy()
    nbr[3] = -1
    nbr[-7:] = -1
    out = gather_gemm(torch.from_numpy(x).to(dtype), torch.from_numpy(nbr),
                      torch.from_numpy(w).to(dtype))
    assert out.dtype == torch.float32
    assert (out[3] == 0).all() and (out[-7:] == 0).all()
    assert (out[:3].abs().sum(dim=1) > 0).all()
    ref = np.asarray(jax_sparse_conv(jnp.asarray(x), jnp.asarray(nbr),
                                     jnp.asarray(w), compute_dtype=jnp.float32))
    assert (ref[3] == 0).all()


def test_masked_norms_match_jax():
    """Valid-row statistics and per-sample normalization, f32: 1e-5."""
    rng = np.random.RandomState(9)
    n, c = 300, 16
    feats = (rng.randn(n, c) * 2 + 1).astype(np.float32)
    num_valid = 250
    mask = np.arange(n) < num_valid
    bids = np.where(mask, (np.arange(n) >= 120).astype(np.int32), 2)
    mj, vj = jops.masked_batchnorm_stats(jnp.asarray(feats), jnp.asarray(mask),
                                         jnp.int32(num_valid))
    mt, vt = masked_batchnorm_stats(torch.from_numpy(feats), torch.from_numpy(mask),
                                    torch.tensor(num_valid))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-5)
    ij = jops.masked_instancenorm(jnp.asarray(feats), jnp.asarray(bids),
                                  jnp.asarray(mask), 2)
    it = masked_instancenorm(torch.from_numpy(feats), torch.from_numpy(bids),
                             torch.from_numpy(mask), 2)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=1e-5)
    assert (it[~torch.from_numpy(mask)] == 0).all()
