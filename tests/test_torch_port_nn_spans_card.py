"""Kernel B's valid spans on the card (``cuda`` marker; each test skips
without one). The file imports no JAX.

The walk over the spans against the whole walk, bit for bit: the whole walk
is forced by one more valid reference after the last, far from every query
(so it is never chosen, and the valid span is the whole range), and by
searching every query; a valid query's index and d² must not change. At
eval-kitti's shape (131 072² × 32, about 67 000 valid a side, a prefix),
at the training search's (65 536² × 3, the references one pair's segment,
every query), and at the main path's 5 000² × 32, every row valid.
Then one captured graph replayed with different valid counts gives each
replay's own answer and tally, and the launches are counted as before.

    python3 -m pytest tests/test_torch_port_nn_spans_card.py -q -p no:cacheprovider
"""
import pytest
import torch

from imfnet_tpu_torch.match.nn import nn_auto
from imfnet_tpu_torch.match.nn_kernel import flash_nn, nn_plain, nn_plan
from imfnet_tpu_torch.utils import timer
from imfnet_tpu_torch.utils.graphs import jit

pytestmark = pytest.mark.cuda
NN_TIE = 1e-5      # plain d² of the kernel's choice against the plain best


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B is built with nvcc and runs only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _unit_rows(gen, k, d):
    x = torch.randn((k, d), generator=gen, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


def _far_last(r, r_ok):
    """The references with one more row, valid and far from every unit
    query: the valid span becomes the whole range, no choice changes."""
    far = torch.full_like(r[:1], 1e3 / r.shape[1] ** 0.5)
    return torch.cat([r, far]), torch.cat([r_ok, r_ok.new_ones(1)])


def expected_walk(n, m, d, q_span, r_span):
    """Query rows x reference rows the kernel's walking blocks cover."""
    plan = nn_plan(n, m, d)
    q_lo, q_hi = q_span
    return sum((b - a) * (stop - start) for a, b in plan.query_ranges(n)
               if a < q_hi and a + plan.bq > q_lo for start, stop in plan.part_ranges(m, r_span))


def _assert_span_walk_is_the_whole_walk(q, r, q_ok, r_ok, plain_rows=4096):
    n, m, d = q.shape[0], r.shape[0], q.shape[1]
    timer.reset()
    with timer.tracing():
        i_s, d_s = flash_nn(q, r, r_ok, q_ok)
        rec = timer.record()
    timer.reset()
    r_w, ok_w = _far_last(r, r_ok)
    i_w, d_w = flash_nn(q, r_w, ok_w)               # every query, every tile
    torch.cuda.synchronize()
    qv = torch.ones(n, dtype=torch.bool, device=q.device) if q_ok is None else q_ok
    assert torch.equal(i_s[qv], i_w[qv]) and torch.equal(d_s[qv], d_w[qv])
    assert (i_s[~qv] == 0).all() and torch.isinf(d_s[~qv]).all()
    # the tally the host reads while tracing
    assert rec["counters"] == {"nn.rows_full": n * m,
                               "nn.rows_walked": expected_walk(n, m, d, _span(qv), _span(r_ok))}
    # indices against the plain version on a sample of the valid queries
    rows = qv.nonzero()[:, 0]
    rows = rows[torch.randperm(len(rows), device=q.device)[:plain_rows]]
    best, best_d = nn_plain(q[rows], r, r_ok)
    got_d = ((q[rows] - r[i_s[rows].long()]) ** 2).sum(1)
    assert r_ok[i_s[rows].long()].all()
    assert (got_d <= best_d + NN_TIE).all()
    assert (i_s[rows] == best).float().mean() > 0.999
    return rec


def test_kitti_prefixes(gen):
    """eval-kitti: 131 072 rows a side, about 67 000 valid, a prefix."""
    n = 131072
    q, r = _unit_rows(gen, n, 32), _unit_rows(gen, n, 32)
    j = torch.arange(n, device="cuda")
    rec = _assert_span_walk_is_the_whole_walk(q, r, j < 67003, j < 66871)
    share = rec["counters"]["nn.rows_walked"] / rec["counters"]["nn.rows_full"]
    assert 0.25 < share < 0.28


def test_training_segment(gen):
    """The positive search: 65 536² × 3, references one pair's segment,
    every query searched (no query mask)."""
    n = 65536
    q, r = _unit_rows(gen, n, 3), _unit_rows(gen, n, 3)
    j = torch.arange(n, device="cuda")
    seg = (j >= 27111) & (j < 27111 + 26980)
    _assert_span_walk_is_the_whole_walk(q, r, None, seg)


@pytest.mark.parametrize("d", [32, 16])
def test_main_path_every_row_valid(gen, d):
    """5 000² with every keypoint valid: the walk is the whole one, and the
    tally N x M."""
    q, r = _unit_rows(gen, 5000, d), _unit_rows(gen, 5000, d)
    ok = torch.ones(5000, dtype=torch.bool, device="cuda")
    rec = _assert_span_walk_is_the_whole_walk(q, r, ok, ok)
    assert rec["counters"]["nn.rows_walked"] == 5000 * 5000


@pytest.mark.parametrize("kind", ["middle", "scattered", "one", "none"])
def test_other_masks(gen, kind):
    n, m = 5000, 7000
    q, r = _unit_rows(gen, n, 32), _unit_rows(gen, m, 32)
    jq, jr = torch.arange(n, device="cuda"), torch.arange(m, device="cuda")
    masks = {"middle": ((jq >= 1300) & (jq < 3100), (jr >= 2000) & (jr < 4500)),
             "scattered": (torch.rand(n, generator=gen, device="cuda") > 0.7,
                           torch.rand(m, generator=gen, device="cuda") > 0.7),
             "one": (jq == 4321, jr == 17),
             "none": (jq < 0, jr < 0)}[kind]
    q_ok, r_ok = masks
    if kind == "none":
        i_s, d_s = flash_nn(q, r, r_ok, q_ok)
        assert (i_s == 0).all() and torch.isinf(d_s).all()
        return
    _assert_span_walk_is_the_whole_walk(q, r, q_ok, r_ok)


def _span(v):
    rows = v.nonzero()[:, 0]
    return (int(rows[0]), int(rows[-1]) + 1) if len(rows) else (len(v), 0)


def test_one_graph_serves_every_count(gen):
    """One capture, replayed with other valid counts: each replay gives
    the eager answer for its own masks, bit for bit, and its own tally;
    one launch of kernel B a replay, as eagerly."""
    n = 20000
    q, r = _unit_rows(gen, n, 32), _unit_rows(gen, n, 32)
    j = torch.arange(n, device="cuda")

    def search(q, r, q_ok, r_ok):
        return nn_auto(q, r, r_ok, query_valid=q_ok)

    graphed = jit(search)
    counts = [(12000, 9000), (12000, 9000), (300, 19999), (19999, 64), (20000, 20000),
              (5, 0), (0, 7000), (15000, 15000)]
    masks = [(j < a, j < b) for a, b in counts]
    masks.append(((j >= 4000) & (j < 9000), (j >= 11111) & (j < 13000)))
    before = flash_nn.launches
    for q_ok, r_ok in masks[:2]:                    # warm-up, then the capture
        graphed(q, r, q_ok, r_ok)
    assert graphed.launches_per_replay()["flash_nn.launches"] == 1
    timer.reset()
    with timer.tracing():
        for q_ok, r_ok in masks[2:]:
            i_g, d_g = (t.clone() for t in graphed(q, r, q_ok, r_ok))
            i_e, d_e = flash_nn(q, r, r_ok, q_ok)
            assert torch.equal(i_g, i_e) and torch.equal(d_g, d_e)
            assert (i_g[~q_ok] == 0).all() and torch.isinf(d_g[~q_ok]).all()
            if r_ok.any():
                assert r_ok[i_g[q_ok].long()].all()
        rec = timer.record()
    timer.reset()
    assert graphed.captures == 1 and graphed.replays == len(masks) - 1
    assert flash_nn.launches == before + 2 * (len(masks) - 1)
    # each replay's tally and the eager call's, alike
    walked = sum(expected_walk(n, n, 32, _span(a), _span(b)) for a, b in masks[2:])
    assert rec["counters"] == {"nn.rows_full": 2 * (len(masks) - 2) * n * n,
                               "nn.rows_walked": 2 * walked}
