"""Port parity, matching: the flash-NN plain version against the JAX
package's blocked NN and its Pallas kernel (interpret mode), plus mutual NN
and radius matching. Gaussian inputs have no near-ties, so indices must be
equal; squared distances agree to 1e-4 (f32 sums of 32 products of O(1)
values, taken in another order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.match.nn import blocked_nn as jax_blocked_nn
from imfnet_tpu.match.nn import find_nn as jax_find_nn
from imfnet_tpu.match.nn import mutual_nn as jax_mutual_nn
from imfnet_tpu.match.nn import radius_match as jax_radius_match
from imfnet_tpu.match.pallas_nn import nn_pallas

from imfnet_tpu_torch.match.nn import (blocked_nn, find_nn, mutual_nn, nn_auto,
                                       radius_match)
from imfnet_tpu_torch.match.nn_kernel import flash_nn, nn_plain

D2_ATOL = 1e-4


def _case(seed, n, m, d, valid_kind):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, d).astype(np.float32)
    r = rng.randn(m, d).astype(np.float32)
    if valid_kind == "some":
        valid = rng.rand(m) > 0.2
    elif valid_kind == "one":
        valid = np.zeros(m, bool)
        valid[m // 3] = True
    elif valid_kind == "none":
        valid = np.zeros(m, bool)
    else:
        valid = np.ones(m, bool)
    return q, r, valid


@pytest.mark.parametrize("d", [32, 3])
@pytest.mark.parametrize("valid_kind", ["all", "some", "one", "none"])
def test_nn_plain_matches_jax(d, valid_kind):
    q, r, valid = _case(d, 300, 700, d, valid_kind)
    i_b, d_b = jax_blocked_nn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                              block=256, with_dist=True)
    i_p, d_p = nn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                         tq=64, tr=128, interpret=True)
    i_t, d_t = flash_nn(torch.from_numpy(q), torch.from_numpy(r),
                        torch.from_numpy(valid))
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_b))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    if valid_kind == "none":
        assert (i_t.numpy() == 0).all() and np.isinf(d_t.numpy()).all()
        assert np.isinf(np.asarray(d_b)).all() and np.isinf(np.asarray(d_p)).all()
    else:
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_b), rtol=0, atol=D2_ATOL)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), rtol=0, atol=D2_ATOL)
    if valid_kind == "one":
        assert (i_t.numpy() == 700 // 3).all()


def test_nn_plain_block_size_and_ties():
    """Results do not depend on the block size; exact ties go to the
    lowest index, within and across blocks."""
    q, r, valid = _case(7, 200, 1000, 32, "some")
    a = nn_plain(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(valid),
                 block=128)
    b = nn_plain(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(valid),
                 block=4096)
    assert torch.equal(a[0], b[0]) and torch.allclose(a[1], b[1], atol=D2_ATOL)
    # small integers: every product and sum is exact, so equal rows tie exactly
    base = np.random.RandomState(8).randint(-3, 4, (10, 32)).astype(np.float32)
    r_dup = np.concatenate([base, base, base])       # rows j, j+10, j+20 equal
    for block in (7, 15, 64):
        idx, d2 = nn_plain(torch.from_numpy(base), torch.from_numpy(r_dup),
                           block=block)
        np.testing.assert_array_equal(idx.numpy(), np.arange(10))
        assert (d2 == 0).all()


def test_blocked_auto_and_find_nn_agree():
    q, r, valid = _case(3, 100, 400, 32, "some")
    qt, rt, vt = map(torch.from_numpy, (q, r, valid))
    i_a, d_a = nn_auto(qt, rt, vt)
    i_b, d_b = blocked_nn(qt, rt, vt, block=64, with_dist=True)
    assert torch.equal(i_a, i_b) and torch.allclose(d_a, d_b, atol=D2_ATOL)
    i_f = find_nn(qt, rt, vt)
    np.testing.assert_array_equal(i_f.numpy(), np.asarray(jax_find_nn(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid), block=128)))


def test_mutual_nn_matches_jax():
    rng = np.random.RandomState(11)
    f0 = rng.randn(400, 32).astype(np.float32)
    f1 = np.concatenate([f0[:200] + rng.randn(200, 32).astype(np.float32) * 0.05,
                         rng.randn(300, 32).astype(np.float32)])
    v0 = rng.rand(400) > 0.1
    v1 = rng.rand(500) > 0.1
    nn01_j, mut_j = jax_mutual_nn(jnp.asarray(f0), jnp.asarray(f1),
                                  jnp.asarray(v0), jnp.asarray(v1), block=128)
    nn01_t, mut_t = mutual_nn(*map(torch.from_numpy, (f0, f1, v0, v1)))
    np.testing.assert_array_equal(nn01_t.numpy(), np.asarray(nn01_j))
    np.testing.assert_array_equal(mut_t.numpy(), np.asarray(mut_j))
    assert mut_t.sum() > 100


def test_radius_match_matches_jax():
    rng = np.random.RandomState(12)
    x0 = rng.rand(600, 3).astype(np.float32)
    x1 = (x0 + rng.randn(600, 3).astype(np.float32) * 0.02)[rng.permutation(600)]
    v0 = rng.rand(600) > 0.1
    v1 = rng.rand(600) > 0.1
    idx_j, ok_j = jax_radius_match(jnp.asarray(x0), jnp.asarray(x1),
                                   jnp.asarray(v0), jnp.asarray(v1), 0.03,
                                   block=256)
    idx_t, ok_t = radius_match(*map(torch.from_numpy, (x0, x1, v0, v1)), 0.03)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert 0 < ok_t.sum() < 600
