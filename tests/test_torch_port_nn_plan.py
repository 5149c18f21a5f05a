"""Kernel B's host side, without a card: the plan that picks its tile and
its cluster split (``match/nn_kernel.py::nn_plan``), a plain emulation of
the split (each part's nearest by the plain version, parts merged by
(distance, lowest index), as the kernel merges them) against the plain
version over the whole and against the JAX package's TPU kernel in interpret
mode, and the wrapper's CPU path."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.match.pallas_nn import nn_pallas

from imfnet_tpu_torch.match.nn_kernel import (KERNEL_DIMS, MAX_SPLIT, NN_CHUNK_TILES,
                                                NN_MIN_GEOMETRY, NN_MIN_TILE,
                                                NN_MIN_TILES, NN_TILE, NN_TILES, SMEM_LIMIT,
                                                TARGET_BLOCKS, NNPlan, built, flash_nn,
                                                nn_plain, nn_plan, nn_smem_bytes, run_plan)

H100_SMS = 132
SIZES = [1, 31, 129, 5000, 5003]
# the widths with a fold of their own and others, which take the chunk fold
ALL_DIMS = KERNEL_DIMS + (1, 16, 64, 256)


def split_emulation(q, r, valid, plan):
    """What the kernel computes, in plain PyTorch: per part of the split the
    plain version's nearest valid reference ((0, +inf) for a part with
    none), then the parts merged in rank order by (d, index)."""
    n = q.shape[0]
    best_d = torch.full((n,), float("inf"))
    best_i = torch.zeros((n,), dtype=torch.int32)
    for start, stop in plan.part_ranges(r.shape[0]):
        v = None if valid is None else valid[start:stop]
        idx, d2 = nn_plain(q, r[start:stop], v)
        idx = torch.where(torch.isinf(d2), 0, idx + start).to(torch.int32)
        nearer = (d2 < best_d) | ((d2 == best_d) & (idx < best_i))
        best_d = torch.where(nearer, d2, best_d)
        best_i = torch.where(nearer, idx, best_i)
    return best_i, best_d


@pytest.mark.parametrize("d", ALL_DIMS)
@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("n", SIZES)
def test_plan_covers_every_query_and_reference_once(n, m, d):
    plan = nn_plan(n, m, d)
    assert built(plan, d) and 1 <= plan.split <= MAX_SPLIT
    assert plan.fold == {3: "min", 32: "pair"}.get(d, "chunk")
    assert nn_smem_bytes(plan.bq, plan.br, d, plan.fold) <= SMEM_LIMIT
    queries = [i for a, b in plan.query_ranges(n) for i in range(a, b)]
    assert queries == list(range(n))
    assert all(b - a <= plan.bq for a, b in plan.query_ranges(n))
    parts = plan.part_ranges(m)
    assert len(parts) == plan.split
    refs = [j for a, b in parts for j in range(a, b)]
    assert refs == list(range(m))
    # parts are whole tiles, balanced within one tile, and none is empty
    # unless there are fewer tiles than parts (the plan never asks for that)
    tiles = [-(-(b - a) // plan.br) for a, b in parts]
    assert max(tiles) - min(tiles) <= 1 and min(tiles) >= 1
    assert plan.blocks(n) == len(plan.query_ranges(n)) * plan.split


def test_plan_fills_the_card_at_the_main_path_shape():
    plan = nn_plan(5000, 5000, 32)
    assert plan.blocks(5000) >= 120
    assert plan.blocks(5000) >= TARGET_BLOCKS >= H100_SMS
    # the least split that does: one part fewer falls short
    assert plan._replace(split=plan.split - 1).blocks(5000) < TARGET_BLOCKS
    # many queries need no split
    assert nn_plan(100_000, 5000, 32).split == 1


@pytest.mark.parametrize("n,m,d", [(131072, 131072, 32), (131072, 131072, 3),
                                   (65536, 131072, 3)])
def test_plan_holds_at_the_kitti_shapes(n, m, d):
    """KITTI's registration over every voxel (131 072² × 32) and ICP at scan
    scale (clouds padded to 2^16-2^17, D = 3): enough query tiles that no
    split is needed, a grid far inside CUDA's limits, shared memory that
    fits, and a scratch whose int32 offsets do not overflow."""
    plan = nn_plan(n, m, d)
    assert plan.split == 1 and plan.blocks(n) == n // plan.bq >= TARGET_BLOCKS
    assert nn_smem_bytes(plan.bq, plan.br, d, plan.fold) <= SMEM_LIMIT
    pad = 128
    rows = -(-n // pad) * pad + -(-m // pad) * pad
    assert (d + 1) * rows < 2 ** 31


@pytest.mark.parametrize("bq,br,threads", sorted(NN_TILES))
@pytest.mark.parametrize("d", ALL_DIMS)
def test_every_instance_fits_shared_memory(bq, br, threads, d):
    # the pair fold is built at D = 32; D = 3 takes the min fold, every
    # other D the chunk fold, whose shared memory does not grow with D
    assert built(NNPlan(bq, br, threads, 1), d) == (d == 32)
    assert (nn_smem_bytes(bq, br, d) <= SMEM_LIMIT) or d > 128
    # three stages of k-major reference tiles with their norms, the query
    # tile with its norms, one (d, index) per query
    assert nn_smem_bytes(bq, br, d) >= ((d + 1) * (bq + 3 * br) + 2 * bq) * 4
    if (bq, br, threads) in NN_CHUNK_TILES:
        assert built(NNPlan(bq, br, threads, 1, "chunk"), d)
        assert nn_smem_bytes(bq, br, d, "chunk") <= SMEM_LIMIT


@pytest.mark.parametrize("bq,br,threads", sorted(NN_MIN_TILES))
def test_every_min_fold_instance_fits_shared_memory(bq, br, threads):
    """The min fold keeps its queries in registers: three stages of
    reference tiles, the merge's 16 bests a query row, one (d, index) per
    query. It is built at D = 3 alone, and its reference tile divides the
    scratch's 128-row padding."""
    assert nn_smem_bytes(bq, br, 3, "min") <= SMEM_LIMIT
    assert nn_smem_bytes(bq, br, 3, "min") == (max(3 * 4 * br, 32 * bq) + 2 * bq) * 4
    assert 128 % br == 0 and bq % 4 == 0
    tq, tr, gy, gx = NN_MIN_GEOMETRY[(bq, br, threads)]
    assert (tq * gy, tr * gx, gy * gx) == (bq, br, threads)
    assert tq % 4 == 0 and tr % 4 == 0 and gy % 4 == 0 and gx % 8 == 0 and gx <= 16
    assert built(NNPlan(bq, br, threads, 1, "min"), 3)
    assert not built(NNPlan(bq, br, threads, 1, "min"), 32)


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("n", SIZES)
def test_d32_plan_is_unchanged_and_d3_takes_the_min_fold(n, m):
    """D = 32 keeps the pair fold in NN_TILE and its split rule; D = 3 the
    min fold in NN_MIN_TILE, split by the same rule."""
    for d, tile, fold in ((32, NN_TILE, "pair"), (3, NN_MIN_TILE, "min")):
        bq, br, threads = tile
        split = min(-(-TARGET_BLOCKS // max(1, -(-n // bq))), MAX_SPLIT, max(1, -(-m // br)))
        assert nn_plan(n, m, d) == NNPlan(bq, br, threads, split, fold)
    assert NN_TILE in NN_TILES and NN_MIN_TILE in NN_MIN_TILES


def _inputs(seed, n, m, d):
    """Gaussian directions as unit rows, as the descriptors are: d² stays
    below 4, where 1e-5 is some forty f32 roundings."""
    rng = np.random.RandomState(seed)
    q, r = rng.randn(n, d), rng.randn(m, d)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    r = (r / np.linalg.norm(r, axis=1, keepdims=True)).astype(np.float32)
    valid = rng.rand(m) > 0.2
    return q, r, valid


@pytest.mark.parametrize("split", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("case", ["masked", "no mask", "ties", "a part all invalid",
                                  "all invalid", "fewer tiles than parts"])
def test_split_emulation_equals_plain(case, split):
    """Merging the parts by (d, index) gives the plain version's answer over
    the whole: indices equal, ties and parts without a valid reference
    included; d² equal up to the matmul's summation order over another
    block of references (1e-5)."""
    m = 100 if case == "fewer tiles than parts" else 700
    q, r, valid = _inputs(0, 300, m, 32)
    plan = NNPlan(64, 64, 256, split)
    if case == "no mask":
        valid = None
    elif case == "ties":
        r[m // 2:] = r[:m // 2]                  # every reference twice
        valid = None
    elif case == "a part all invalid":
        start, stop = plan.part_ranges(m)[0]
        valid[start:stop] = split == 1           # (with one part: all valid)
    elif case == "all invalid":
        valid[:] = False
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    vt = None if valid is None else torch.from_numpy(valid)
    idx, d2 = split_emulation(qt, rt, vt, plan)
    ref_i, ref_d = nn_plain(qt, rt, vt)
    assert torch.equal(idx, ref_i)
    if case == "ties":
        assert (idx < m // 2).all()
    if case == "all invalid":
        assert (idx == 0).all() and torch.isinf(d2).all()
    else:
        torch.testing.assert_close(d2, ref_d, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", ALL_DIMS)
@pytest.mark.parametrize("n,m", [(300, 700), (129, 5003), (31, 129)])
def test_split_emulation_equals_pallas_kernel(n, m, d):
    """The plan's split, emulated, against the TPU kernel in interpret mode
    on Gaussian inputs (no near-ties): indices equal, d² within 1e-5."""
    q, r, valid = _inputs(1, n, m, d)
    ref_i, ref_d = nn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                             tq=128, tr=256, interpret=True)
    plan = nn_plan(n, m, d)
    assert plan.split > 1
    idx, d2 = split_emulation(torch.from_numpy(q), torch.from_numpy(r),
                              torch.from_numpy(valid), plan)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d), rtol=0, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors and counts no launch
    before = flash_nn.launches
    got_i, got_d = flash_nn(torch.from_numpy(q), torch.from_numpy(r),
                            torch.from_numpy(valid))
    assert flash_nn.launches == before
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=0, atol=1e-5)


def test_run_plan_needs_cuda_tensors():
    q = torch.zeros((4, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_plan(q, q, None, nn_plan(4, 4, 32))
