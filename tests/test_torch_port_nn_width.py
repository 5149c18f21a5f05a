"""Kernel B at every descriptor width, without a card.

The TPU kernel pads D to a multiple of 8 and so serves any width
(``imfnet_tpu/match/pallas_nn.py:71``); the port's kernel B serves D = 3
(the min fold) and D = 32 (the pair fold) with instances of their own, and
every other D >= 1 with the chunk fold: D zero-padded to a multiple of
``CHUNK_K``, the contraction staged a chunk at a time, so its shared memory
is the same at every width. Here, on numpy-seeded inputs with ties and
invalid references: the wrapper's CPU path (the plain version) against the
JAX package's ``blocked_nn`` and ``nn_pallas`` in interpret mode, indices
exact and d² within 1e-4; the plan's split over the zero-padded width,
emulated, against the same; and the plan, the instances and their shared
memory at each width. The launched kernel is held to the plain version on
the card (``tests/test_torch_port_kernels.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.match.nn import blocked_nn as jax_blocked_nn
from imfnet_tpu.match.pallas_nn import nn_pallas

from imfnet_tpu_torch.match.nn_kernel import (CHUNK_K, KERNEL_DIMS, MAX_SPLIT, NN_CHUNK_TILE,
                                                NN_CHUNK_TILES, NN_MIN_TILE, NN_TILE,
                                                SMEM_LIMIT, TARGET_BLOCKS, NNPlan, built,
                                                flash_nn, nn_plain, nn_plan, nn_smem_bytes,
                                                padded_width)

from test_torch_port_nn_plan import split_emulation

WIDTHS = (1, 5, 8, 16, 24, 64, 256)   # model_n_out values and their edges
D2_ATOL = 1e-4


def _rows(rng, k, d):
    """Unit rows of Gaussian directions, as the descriptors are (d² below 4,
    where 1e-4 is some hundred f32 roundings); at D = 1 multiples of 1/8,
    whose distances are exact, so equal ones are true ties."""
    if d == 1:
        return (rng.randint(-40, 40, (k, 1)) / 8).astype(np.float32)
    x = rng.randn(k, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _case(seed, n, m, d, kind):
    """``kind`` "ties": every reference twice (both copies give bit-equal
    distances, the lower index must win); "invalid": a fifth of the
    references masked, and a whole block of them."""
    rng = np.random.RandomState(seed)
    q, r = _rows(rng, n, d), _rows(rng, m, d)
    valid = np.ones(m, bool)
    if kind == "ties":
        h = m // 2
        r[h:2 * h] = r[:h]
    else:
        valid = rng.rand(m) > 0.2
        valid[100:228] = False
    return q, r, valid


@pytest.mark.parametrize("kind", ["ties", "invalid"])
@pytest.mark.parametrize("d", WIDTHS)
def test_flash_nn_at_any_width_matches_jax(d, kind):
    q, r, valid = _case(d, 300, 700, d, kind)
    i_b, d_b = jax_blocked_nn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                              block=256, with_dist=True)
    i_p, d_p = nn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                         tq=64, tr=128, interpret=True)
    before = flash_nn.launches
    i_t, d_t = flash_nn(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(valid))
    assert flash_nn.launches == before          # the CPU runs the plain version
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_b))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_b), rtol=0, atol=D2_ATOL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), rtol=0, atol=D2_ATOL)
    if kind == "ties":
        assert (i_t.numpy() < 350).all()
    else:
        assert valid[i_t.numpy()].all()


@pytest.mark.parametrize("d", WIDTHS)
def test_zero_columns_change_no_choice(d):
    """The chunk fold's padding: the zero-padded inputs give the plain
    version's indices exactly and d² within the summation order's 1e-4."""
    q, r, valid = _case(d + 1, 300, 700, d, "invalid")
    dp = padded_width(d, "chunk")
    assert dp % CHUNK_K == 0 and d <= dp < d + CHUNK_K
    qp, rp = (np.pad(a, ((0, 0), (0, dp - d))) for a in (q, r))
    vt = torch.from_numpy(valid)
    i0, d0 = nn_plain(torch.from_numpy(q), torch.from_numpy(r), vt)
    i1, d1 = nn_plain(torch.from_numpy(qp), torch.from_numpy(rp), vt)
    assert torch.equal(i0, i1)
    torch.testing.assert_close(d0, d1, rtol=0, atol=D2_ATOL)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("n,m", [(300, 700), (129, 5003), (31, 129)])
def test_chunk_fold_split_equals_pallas_kernel(n, m, d):
    """The plan at a width of its own: the chunk fold, split over the
    cluster as at D = 32; its parts, emulated on the zero-padded inputs and
    merged by (d, index), against the TPU kernel in interpret mode."""
    q, r, valid = _case(7 * d, n, m, d, "invalid" if m > 228 else "ties")
    plan = nn_plan(n, m, d)
    assert plan.fold == "chunk" and plan.split > 1
    dp = padded_width(d, "chunk")
    qp, rp = (torch.from_numpy(np.pad(a, ((0, 0), (0, dp - d)))) for a in (q, r))
    idx, d2 = split_emulation(qp, rp, torch.from_numpy(valid), plan)
    ref_i, ref_d = nn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                             tq=128, tr=256, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d), rtol=0, atol=D2_ATOL)


@pytest.mark.parametrize("d", WIDTHS + (2, 33, 1000))
def test_every_width_has_an_instance_that_fits(d):
    """nn_plan gives each width an instance that is built and fits the
    H100's 227 KB; the chunk fold's shared memory does not grow with D,
    where the pair fold's would not fit above D = 128 at its tile."""
    for n, m in ((5000, 5000), (131072, 131072), (1, 31)):
        plan = nn_plan(n, m, d)
        assert built(plan, d) and 1 <= plan.split <= MAX_SPLIT
        assert nn_smem_bytes(plan.bq, plan.br, d, plan.fold) <= SMEM_LIMIT
    assert nn_plan(5000, 5000, d).fold == {3: "min", 32: "pair"}.get(d, "chunk")
    for bq, br, threads in NN_CHUNK_TILES:
        assert built(NNPlan(bq, br, threads, 1, "chunk"), d)
        assert nn_smem_bytes(bq, br, d, "chunk") == nn_smem_bytes(bq, br, 1, "chunk")
        assert nn_smem_bytes(bq, br, d, "chunk") <= SMEM_LIMIT
    bq, br, _ = NN_TILE
    assert (nn_smem_bytes(bq, br, d, "pair") <= SMEM_LIMIT) == (d <= 128)


def test_the_d3_and_d32_plans_are_unchanged():
    """D = 3 keeps the min fold at NN_MIN_TILE, D = 32 the pair fold at
    NN_TILE, and each other width the chunk fold at the pair fold's tile,
    split by the same rule; nothing but the chunk fold is built at other
    widths."""
    assert KERNEL_DIMS == (3, 32)
    assert NN_TILE == (64, 128, 128) and NN_MIN_TILE == (256, 128, 128)
    assert NN_CHUNK_TILE == NN_TILE and NN_CHUNK_TILE in NN_CHUNK_TILES
    for n, m in ((5000, 5000), (65536, 65536), (131072, 131072), (300, 700)):
        for d, tile, fold in ((3, NN_MIN_TILE, "min"), (32, NN_TILE, "pair"),
                              (16, NN_CHUNK_TILE, "chunk"), (64, NN_CHUNK_TILE, "chunk")):
            bq, br, threads = tile
            split = min(-(-TARGET_BLOCKS // max(1, -(-n // bq))), MAX_SPLIT,
                        max(1, -(-m // br)))
            assert nn_plan(n, m, d) == NNPlan(bq, br, threads, split, fold)
    for fold, d in (("pair", 16), ("min", 16), ("pair", 3), ("min", 32)):
        bq, br, threads = NN_TILE if fold == "pair" else NN_MIN_TILE
        assert not built(NNPlan(bq, br, threads, 1, fold), d)
    assert padded_width(32, "pair") == 32 and padded_width(3, "min") == 3
    assert padded_width(16, "chunk") == 16 and padded_width(17, "chunk") == 24
