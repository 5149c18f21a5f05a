"""Kernel B's valid spans, without a card.

Kernel B bounds its work by the masks of its operands on the card: its
pre-pass reduces the span of the valid queries, [q_lo, q_hi), and of the
valid references, [r_lo, r_hi); a block whose query tile misses the query
span only stores (0, +inf), the others walk only the reference tiles that
meet the reference span (``NNPlan.part_ranges`` with the span), and a query
that is not valid gets (0, +inf). Here: the plain version's query mask, an
emulation of that walk against the JAX package's TPU kernel in interpret
mode on every valid query (prefixes, a middle segment, scattered rows, one
row, none and all, with ties and invalid references), the parts of a span,
the walked rows' tally, the device counters it is read through
(``utils.timer.count_device``), and the pair registration's metrics with
and without the query masks. The launched kernel is held to the same on
the card (``tests/test_torch_port_nn_spans_card.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.match.pallas_nn import nn_pallas

from imfnet_tpu_torch.eval import registration
from imfnet_tpu_torch.match.nn import nn_auto, queries_valid
from imfnet_tpu_torch.match.nn_kernel import (NNPlan, flash_nn, nn_plain, nn_plan,
                                                padded_width)
from imfnet_tpu_torch.utils import timer

D2_ATOL = 1e-4
MASKS = ("prefix", "middle", "scattered", "one", "none", "all")


def _mask(kind, k, rng):
    j = np.arange(k)
    return {"prefix": j < (k * 5) // 9, "middle": (j >= k // 3) & (j < (k * 2) // 3),
            "scattered": rng.rand(k) > 0.6, "one": j == (k * 3) // 7,
            "none": np.zeros(k, bool), "all": np.ones(k, bool)}[kind]


def _case(seed, n, m, d, kind):
    """Unit rows (the second half of the references a copy of the first,
    so the lower index must win every tie), the query mask and the
    reference mask of one ``kind``, the latter with a few more holes."""
    rng = np.random.RandomState(seed)
    q, r = rng.randn(n, d), rng.randn(m, d)
    q, r = ((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32) for x in (q, r))
    r[m // 2:2 * (m // 2)] = r[:m // 2]
    q_ok, r_ok = _mask(kind, n, rng), _mask(kind, m, rng)
    if kind not in ("one", "none"):
        r_ok &= rng.rand(m) > 0.1
    return q, r, q_ok, r_ok


def span(mask):
    """[lowest, highest + 1) of the True rows; (len, 0) if there is none, as
    the kernel's words decode."""
    rows = np.flatnonzero(np.asarray(mask))
    return (int(rows[0]), int(rows[-1]) + 1) if len(rows) else (len(mask), 0)


def walk_emulation(q, r, q_ok, r_ok, plan):
    """What the kernel computes, in plain PyTorch: the query tiles that
    meet the query span, each merging the plain version's nearest over each
    part of the reference span's tiles by (d, index); (0, +inf) elsewhere and
    for the queries that are not valid."""
    n, m = q.shape[0], r.shape[0]
    (q_lo, q_hi), r_span = span(q_ok), span(r_ok)
    best_i = torch.zeros(n, dtype=torch.int32)
    best_d = torch.full((n,), float("inf"))
    for a, b in plan.query_ranges(n):
        if not (a < q_hi and a + plan.bq > q_lo):
            continue
        for start, stop in plan.part_ranges(m, r_span):
            idx, d2 = nn_plain(q[a:b], r[start:stop], r_ok[start:stop])
            idx = torch.where(torch.isinf(d2), 0, idx + start).to(torch.int32)
            nearer = (d2 < best_d[a:b]) | ((d2 == best_d[a:b]) & (idx < best_i[a:b]))
            best_d[a:b] = torch.where(nearer, d2, best_d[a:b])
            best_i[a:b] = torch.where(nearer, idx, best_i[a:b])
    best_i = torch.where(q_ok, best_i, 0)
    best_d = torch.where(q_ok, best_d, float("inf"))
    return best_i, best_d


def _check_valid_queries(idx, d2, q, r, q_ok, r_ok):
    """Every valid query against the TPU kernel in interpret mode (index
    exact, d² within 1e-4); every other query (0, +inf)."""
    ref_i, ref_d = nn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(r_ok),
                             tq=64, tr=128, interpret=True)
    ref_i, ref_d = np.asarray(ref_i), np.asarray(ref_d)
    ok = q_ok
    np.testing.assert_array_equal(idx.numpy()[ok], ref_i[ok])
    if r_ok.any():
        np.testing.assert_allclose(d2.numpy()[ok], ref_d[ok], rtol=0, atol=D2_ATOL)
        assert r_ok[idx.numpy()[ok]].all()
    else:
        assert np.isinf(d2.numpy()[ok]).all() and (idx.numpy()[ok] == 0).all()
    assert (idx.numpy()[~ok] == 0).all() and np.isinf(d2.numpy()[~ok]).all()


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("d", [3, 32, 16])
def test_the_plain_version_serves_the_valid_queries(d, kind):
    q, r, q_ok, r_ok = _case(d, 300, 700, d, kind)
    qt, rt, qv, rv = (torch.from_numpy(a) for a in (q, r, q_ok, r_ok))
    idx, d2 = flash_nn(qt, rt, rv, qv)           # the CPU runs the plain version
    _check_valid_queries(idx, d2, q, r, q_ok, r_ok)
    whole_i, whole_d = nn_plain(qt, rt, rv)      # a valid query's answer is unchanged
    assert torch.equal(idx[qv], whole_i[qv]) and torch.equal(d2[qv], whole_d[qv])


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("d", [3, 32, 16])
def test_the_walk_over_the_spans_equals_the_pallas_kernel(d, kind):
    """The plan's walk, tiles and parts as the kernel takes them (the chunk
    fold on the zero-padded inputs), on 700 queries of 11 tiles of 64 and
    1500 references split over the plan's cluster."""
    q, r, q_ok, r_ok = _case(10 + d, 700, 1500, d, kind)
    plan = nn_plan(700, 1500, d)
    dp = padded_width(d, plan.fold)
    qp, rp = (torch.from_numpy(np.pad(a, ((0, 0), (0, dp - d)))) for a in (q, r))
    idx, d2 = walk_emulation(qp, rp, torch.from_numpy(q_ok), torch.from_numpy(r_ok), plan)
    _check_valid_queries(idx, d2, q, r, q_ok, r_ok)


@pytest.mark.parametrize("split", [1, 3, 8])
@pytest.mark.parametrize("lo,hi", [(0, 5000), (0, 1), (1664, 1665), (127, 129), (300, 4000),
                                   (4999, 5000), (5000, 0)])
def test_the_parts_of_a_span(lo, hi, split):
    """The parts cover exactly the tiles that meet [lo, hi), in order,
    balanced within one tile; with the whole range they are the parts
    without a span."""
    plan = NNPlan(64, 128, 128, split, "pair")
    parts = plan.part_ranges(5000, (lo, hi))
    assert len(parts) == split
    rows = [j for a, b in parts for j in range(a, b)]
    if hi <= lo:
        assert rows == []
        return
    first, last = lo // 128 * 128, min(-(-hi // 128) * 128, 5000)
    assert rows == list(range(first, last))
    tiles = [-(-(b - a) // 128) for a, b in parts]
    assert max(tiles) - min(tiles) <= 1
    if (lo, hi) == (0, 5000):
        assert parts == plan.part_ranges(5000)


@pytest.mark.parametrize("n,m,d", [(5000, 5000, 32), (65536, 65536, 3), (131072, 131072, 32),
                                   (700, 1500, 16), (31, 129, 32)])
def test_with_every_row_valid_the_walk_is_the_whole_one(n, m, d):
    """All valid: every query tile walks, each part its tiles of [0, T),
    and the tally is N x M exactly (nn_walk_share 100 %)."""
    plan = nn_plan(n, m, d)
    assert plan.part_ranges(m, (0, m)) == plan.part_ranges(m)
    walked = sum((b - a) * (stop - start) for a, b in plan.query_ranges(n)
                 for start, stop in plan.part_ranges(m, (0, m)))
    assert walked == n * m


def test_the_kitti_tally_is_a_quarter_of_the_padded_search():
    """eval-kitti's 131 072 rows a side with about 67 000 valid, a prefix:
    1047 query tiles of 64 walk 524 reference tiles of 128, about 26 % of
    the padded N x M."""
    n = m = 131072
    plan = nn_plan(n, m, 32)
    q_hi, r_hi = 67000, 67010
    live = [(a, b) for a, b in plan.query_ranges(n) if a < q_hi]
    walked = sum((b - a) * (stop - start) for a, b in live
                 for start, stop in plan.part_ranges(m, (0, r_hi)))
    assert len(live) == 1047 and plan.part_ranges(m, (0, r_hi))[-1][1] == 524 * 128
    assert walked == 1047 * 64 * 524 * 128
    assert 0.25 < walked / (n * m) < 0.28


def test_the_query_mask_comes_from_an_explicit_argument_or_the_block():
    q, r, q_ok, r_ok = (torch.from_numpy(a) for a in _case(5, 50, 80, 32, "scattered"))
    whole = nn_auto(q, r, r_ok)
    masked = nn_auto(q, r, r_ok, query_valid=q_ok)
    with queries_valid(q_ok):
        scoped = nn_auto(q, r, r_ok)
        with queries_valid(None):
            inner = nn_auto(q, r, r_ok)
        overridden = nn_auto(q, r, r_ok, query_valid=torch.ones_like(q_ok))
    after = nn_auto(q, r, r_ok)
    assert all(torch.equal(a, b) for a, b in zip(scoped, masked))
    for got in (inner, overridden, after):
        assert all(torch.equal(a, b) for a, b in zip(got, whole))
    assert (masked[0][~q_ok] == 0).all() and torch.isinf(masked[1][~q_ok]).all()


def test_the_mask_is_checked():
    q = torch.zeros((4, 32))
    with pytest.raises(ValueError, match="query_valid must be bool"):
        flash_nn(q, q, None, torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="query_valid must be bool"):
        flash_nn(q, q, None, torch.ones(4, dtype=torch.int32))


def test_device_counters_are_read_only_while_tracing():
    timer.reset()
    timer.count_device({"nn.rows_walked": torch.tensor([7]), "nn.rows_full": 9})
    assert timer.record()["counters"] == {}
    with timer.tracing():
        word = torch.tensor([5], dtype=torch.int64)
        timer.count_device({"nn.rows_walked": word, "nn.rows_full": 9})
        word += 2                                 # read at record(), as the launch left it
        timer.count_device({"nn.rows_walked": torch.tensor([1]), "nn.rows_full": 3})
        rec = timer.record()
    assert rec["counters"] == {"nn.rows_walked": 8, "nn.rows_full": 12}
    assert timer.record()["counters"] == {"nn.rows_walked": 8, "nn.rows_full": 12}
    timer.reset()
    assert timer.record()["counters"] == {}


def test_the_pair_metrics_are_the_same_with_the_query_masks():
    """register_kp's metrics dict, bit for bit, with the query masks and
    with every query searched (as before them): RANSAC, the inlier ratio
    and the mutual count mask the rows that are not valid."""
    rng = np.random.RandomState(3)
    k, n_valid = 400, 230
    kp0 = torch.from_numpy(rng.rand(k, 3).astype(np.float32))
    T = torch.eye(4)
    T[:3, 3] = torch.tensor([0.02, -0.01, 0.03])
    kp1 = kp0 @ T[:3, :3].T + T[:3, 3] + torch.from_numpy(0.003 * rng.randn(k, 3)).float()
    kd = torch.from_numpy(rng.randn(k, 32).astype(np.float32))
    kd0 = kd / kd.norm(dim=1, keepdim=True)
    kd1 = kd0 + 0.05 * torch.from_numpy(rng.randn(k, 32).astype(np.float32))
    ok0 = torch.arange(k) < n_valid
    ok1 = torch.arange(k) < n_valid - 17
    register_kp = registration.make_keypoint_registration(num_hypotheses=2000, hypo_block=500)
    args = (kp0, kd0, ok0, kp1, kd1, ok1, torch.linalg.inv(T), torch.eye(6))
    samples = torch.rand(register_kp.sample_shape, generator=torch.Generator().manual_seed(1))
    got = register_kp(*args, samples=samples)
    nn_calls = []
    real = registration.nn_auto

    def whole(queries, refs, ref_valid=None):   # every query searched, as before
        with queries_valid(None):
            out = real(queries, refs, ref_valid)
        nn_calls.append(out[0])
        return out

    registration.nn_auto = whole
    try:
        want = register_kp(*args, samples=samples)
    finally:
        registration.nn_auto = real
    assert len(nn_calls) == 2 and (nn_calls[0][n_valid:] != 0).any()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
