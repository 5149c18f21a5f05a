"""Deep Global Registration's 6-D path on the card (``cuda`` marker; each
test skips without one). The file imports no JAX.

Kernel A's wide-K walk (``"tcw"``: the live entries listed on the card by
(rank in their row, offset), then products weight-stationary per list,
round by round, each row's sum in ascending offset order) against ``gather_gemm_plain`` at k_vol 729, for
each (cin, cout) of the 6-D network and at every output-channel tile, over
a map as sparse as a DGR pyramid's, a map with a fully live row and rows of
60-200 live entries, an all-dead map, a centre-only map and one whose tail
rows are dead: two calls bit-equal, the tally on and off bit-equal, dead
rows exactly 0; its list build against ``tcw_lists_plain``; its tally
against a count on the host; the plan at k_vol 729, never scalar for
cin ≥ 8; and ``eval.dgr.DGRRegistrar``'s graph replayed against its eager
call bit for bit, with kernel A's 20 wide-K and one cin = 1 launches and
one of kernel B a replay.

    python3 -m pytest tests/test_torch_port_dgr_card.py -q -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from imfnet_tpu_torch.sparse import conv_kernel
from imfnet_tpu_torch.sparse.conv_kernel import (TCW_BNS, TCW_RANK_SHIFT, conv_plan,
                                                 gather_gemm, gather_gemm_plain, run_plan,
                                                 shared_lists, tcw_lists, tcw_lists_plain,
                                                 tcw_scratch_ints, tcw_tally_plain)
from imfnet_tpu_torch.utils import timer

pytestmark = pytest.mark.cuda
K6 = 3 ** 6
# (cin, cout) of the 6-D network's 20 k3 convs (ResUNetBN2C)
WIDTHS = [(32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
          (256, 128), (256, 64), (128, 64)]
CONV_TOL_REL = 1e-4      # the same exact bf16 products, f32 sums in another order
MAPS = ["dgr", "dense", "dead", "centre", "tail_dead"]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel A is built with nvcc and runs only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def sparse_map(gen, n_out, n_in, k, live=0.02, kind="dgr"):
    """int32[n_out, k]. "dgr": a live share of the entries name a random
    input row, the centre offset of every row live; the last 100 rows dead
    (capacity padding). "dense": as "dgr", with row 0 live at every offset
    and rows 1-40 at 60-200 offsets (long chains of commits a row). "dead":
    every entry -1. "centre": the centre offset alone. "tail_dead": as
    "dgr", every row from n_out // 2 on dead."""
    pick = torch.rand((n_out, k), generator=gen, device="cuda") < live
    rows = torch.randint(0, n_in, (n_out, k), generator=gen, device="cuda")
    nbr = torch.where(pick, rows, torch.full_like(rows, -1))
    if kind == "dead":
        return torch.full_like(nbr, -1).to(torch.int32)
    centre = torch.arange(n_out, device="cuda") % n_in
    if kind == "centre":
        nbr = torch.full_like(nbr, -1)
        nbr[:, k // 2] = centre
        return nbr.to(torch.int32).contiguous()
    nbr[:, k // 2] = centre
    if kind == "dense":
        nbr[0] = rows[0]
        share = torch.linspace(60 / k, 200 / k, 40, device="cuda")[:, None]
        keep = torch.rand((40, k), generator=gen, device="cuda") < share
        nbr[1:41] = torch.where(keep, rows[1:41], nbr[1:41])
    if kind == "tail_dead":
        nbr[n_out // 2:] = -1
    else:
        nbr[n_out - 100:] = -1
    return nbr.to(torch.int32).contiguous()


def _inputs(gen, cin, cout, kind, n_out=1500, n_in=1700):
    x = torch.randn((n_in, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K6, cin, cout), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    return x, sparse_map(gen, n_out, n_in, K6, kind=kind), w


def _close(got, want):
    scale = want.abs().max().clamp_min(1e-6)
    return float((got - want).abs().max() / scale) < CONV_TOL_REL


@pytest.mark.parametrize("cin,cout", WIDTHS)
@pytest.mark.parametrize("kind", MAPS)
def test_wide_k_matches_plain(gen, cin, cout, kind):
    x, nbr, w = _inputs(gen, cin, cout, kind)
    plan = conv_plan(nbr.shape[0], cin, cout, K6, torch.bfloat16)
    assert plan.variant == "tcw"
    before = gather_gemm.launches_tcw
    got = gather_gemm(x, nbr, w)
    assert gather_gemm.launches_tcw == before + 1
    want = gather_gemm_plain(x, nbr, w)
    assert _close(got, want)
    dead = (nbr < 0).all(dim=1)
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    assert torch.equal(got, gather_gemm(x, nbr, w))          # bit-equal across calls
    assert torch.equal(got, run_plan(x, nbr, w, plan, tally=False))  # the tally moves nothing


@pytest.mark.parametrize("n_out,k_vol,cin,cout", [(1, 352, 8, 8), (5, K6, 24, 40),
                                                  (300, 1000, 48, 96), (97, 1024, 16, 264)])
def test_wide_k_at_other_shapes(gen, n_out, k_vol, cin, cout):
    """The walk where cin and cout are multiples of 8 but not of its steps
    and tiles (a cout over 256 in two column tiles), under 32 rows, and at
    other wide kernel volumes up to its 1024: against the plain version."""
    n_in = max(n_out, 40)
    x = torch.randn((n_in, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k_vol, cin, cout), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    pick = torch.rand((n_out, k_vol), generator=gen, device="cuda") < 0.05
    rows = torch.randint(0, n_in, (n_out, k_vol), generator=gen, device="cuda")
    nbr = torch.where(pick, rows, torch.full_like(rows, -1))
    nbr[:, k_vol // 2] = torch.arange(n_out, device="cuda") % n_in
    nbr[0] = rows[0]                      # one row live at every offset
    nbr[n_out - 1 if n_out > 1 else n_out:] = -1
    nbr = nbr.to(torch.int32).contiguous()
    plan = conv_kernel._wide_plan(cin, cout, k_vol)
    got = run_plan(x, nbr, w, plan)
    assert _close(got, gather_gemm_plain(x, nbr, w))
    dead = (nbr < 0).all(dim=1)
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    assert torch.equal(got, run_plan(x, nbr, w, plan))


@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 128), (256, 256)])
def test_wide_k_at_every_tile_and_pass(gen, cin, cout):
    """Every instance of the walk (a narrower tile walking cout in turns)
    and passes of 1 to 729 offsets: the same sums, bit for bit."""
    x, nbr, w = _inputs(gen, cin, cout, "dense")
    want = gather_gemm_plain(x, nbr, w)
    plan = conv_plan(nbr.shape[0], cin, cout, K6, torch.bfloat16)
    first = run_plan(x, nbr, w, plan)
    assert _close(first, want)
    for bn in TCW_BNS:
        for ob in (1, 100, 365, K6):
            got = run_plan(x, nbr, w, plan._replace(bn=bn, split=ob))
            assert torch.equal(got, first), (bn, ob)


@pytest.mark.parametrize("ob", [K6, 243, 7])
@pytest.mark.parametrize("kind", MAPS)
def test_lists_match_the_plain_build(gen, kind, ob):
    """Each pair's list (pass, rank, offset in the pass) holds the rows
    whose rank-r entry is at that offset, with its rank, and the pairs come
    in that order; the offsets' counts, the highest rank, the chunks, the
    rows' flags and the dead rows' zeros."""
    nbr = sparse_map(gen, 1000, 900, K6, kind=kind)
    got = tcw_lists(nbr, cout=64, ob=ob)
    counts, rank = tcw_lists_plain(nbr)
    assert torch.equal(got["offset_counts"].long(), counts)
    assert int(got["entries"]) == int(counts.sum())
    assert int(got["slots"]) == tcw_tally_plain(nbr.cpu())["conv.slots_walked"]
    assert torch.equal(got["flags"], torch.zeros_like(got["flags"]))
    dead = (nbr < 0).all(dim=1)
    assert torch.equal(got["out"][dead], torch.zeros_like(got["out"][dead]))
    top = max(int(rank.max()), 0)
    assert int(got["top_rank"]) == top
    live = rank >= 0
    k_of = torch.nonzero(live)[:, 1]
    pair = (k_of // ob * K6 + rank[live]) * ob + k_of % ob
    sizes = torch.bincount(pair, minlength=got["first"].numel())
    assert int(got["chunks"]) == int((-(-sizes // 64)).sum())
    # the pairs in order: (pass, rank, offset), ranks past the highest empty
    order = torch.arange(sizes.numel(), device="cuda").view(-1, K6, ob)[:, :top + 1].reshape(-1)
    starts = torch.cumsum(sizes[order], 0) - sizes[order]
    assert torch.equal(got["first"][order].long(), starts)
    mask = (1 << TCW_RANK_SHIFT) - 1
    entries = got["lists"].long() & 0xFFFFFFFF
    for p in torch.nonzero(sizes).squeeze(1).tolist():
        part = entries[int(got["first"][p]):int(got["first"][p]) + int(sizes[p])]
        b, rest = divmod(p, K6 * ob)
        r, kl = divmod(rest, ob)
        k = b * ob + kl
        assert bool(((part >> TCW_RANK_SHIFT) == r).all()), p
        want_rows = torch.nonzero(rank[:, k] == r).squeeze(1)
        assert torch.equal(torch.sort(part & mask).values, want_rows), p


@pytest.mark.parametrize("kind", MAPS)
def test_consecutive_calls_share_the_lists(gen, kind):
    """Inside shared_lists, a second call on the same map walks the first
    call's lists (reset rows' flags, zeroed dead rows): bit-equal to a call
    that builds its own, with the same tally; another map builds anew."""
    x, nbr, w = _inputs(gen, 64, 64, kind, n_out=1000, n_in=900)
    x2 = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    w2 = (torch.randn(w.shape, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    other = sparse_map(gen, 1000, 900, K6, kind="dense")
    want = [gather_gemm(x, nbr, w), gather_gemm(x2, nbr, w2), gather_gemm(x, other, w)]
    plan = conv_plan(1000, 64, 64, K6, torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    timer.reset()
    with shared_lists(), timer.tracing():
        got = [gather_gemm(x, nbr, w)]
        kept = conv_kernel._kept_lists(nbr, plan, stream)
        assert kept is not None
        got.append(gather_gemm(x2, nbr, w2))
        assert conv_kernel._kept_lists(nbr, plan, stream) is kept
        got.append(gather_gemm(x, other, w))
        assert conv_kernel._kept_lists(nbr, plan, stream) is None
        rec = timer.record()
    timer.reset()
    assert conv_kernel._kept_lists(other, plan, stream) is None    # the scope has closed
    for g, h in zip(got, want):
        assert torch.equal(g, h)
    counts = tcw_tally_plain(nbr.cpu())
    assert rec["counters"]["conv.entries_live"] == (2 * counts["conv.entries_live"]
                                                    + int((other >= 0).sum()))


def test_scratch_size_is_the_kernels(gen):
    lib = conv_kernel._library()
    for n_out, k, ob in ((1, 352, 352), (1500, K6, K6), (131072, K6, 183), (4096, 1000, 7)):
        assert lib.sparse_conv_tcw_scratch_ints(n_out, k, ob) == tcw_scratch_ints(n_out, k, ob)


def test_plan_at_729_is_never_scalar(gen):
    for n_out in (1, 900, 65536, 131072):
        for cin in (8, 16, 32, 64, 128, 256, 512):
            for cout in (8, 32, 64, 128, 256):
                plan = conv_plan(n_out, cin, cout, K6, torch.bfloat16)
                assert plan.variant == "tcw", (n_out, cin, cout, plan)
    assert conv_plan(131072, 1, 32, K6, torch.bfloat16).variant == "cin1"


@pytest.mark.parametrize("kind", MAPS)
def test_walk_tally_matches_a_host_count(gen, kind):
    n_out, n_in, cin, cout = 1000, 900, 32, 64
    x = torch.randn((n_in, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((K6, cin, cout), generator=gen, device="cuda").to(torch.bfloat16)
    nbr = sparse_map(gen, n_out, n_in, K6, live=0.005, kind=kind)
    want = tcw_tally_plain(nbr.cpu())
    timer.reset()
    with timer.tracing():
        gather_gemm(x, nbr, w)
        rec = timer.record()
    timer.reset()
    got = rec["counters"]
    for name, value in want.items():
        assert got.get(name, 0) == value, name
    # a row's first entry never waits; only later ones can
    firsts = int((nbr >= 0).any(dim=1).sum())
    assert 0 <= got.get("conv.entries_waited", 0) <= want["conv.entries_live"] - firsts


def test_walk_tally_off_leaves_the_output(gen):
    x, nbr, w = _inputs(gen, 64, 64, "dgr", n_out=700, n_in=800)
    plan = conv_plan(700, 64, 64, K6, torch.bfloat16)
    timer.reset()
    with timer.tracing():
        off = run_plan(x, nbr, w, plan, tally=False)
        rec = timer.record()
    assert "conv.slots_walked" not in rec["counters"]
    assert torch.equal(off, run_plan(x, nbr, w, plan))
    timer.reset()


def _scan(rng, n, extent):
    xyz = (rng.random((n * 4, 3)) * extent).astype(np.float32)
    _, first = np.unique(np.floor(xyz / np.float32(0.3)).astype(np.int64), axis=0,
                         return_index=True)
    return xyz[np.sort(first)][:n]


def test_registrar_graph_replays_its_eager_call(gen):
    from imfnet_tpu_torch.config import dgr_kitti_config
    from imfnet_tpu_torch.eval.dgr import DGRRegistrar
    from imfnet_tpu_torch.match.nn_kernel import flash_nn

    rng = np.random.default_rng(0)
    n = 6000
    xyz0 = _scan(rng, n, (30.0, 30.0, 3.0))
    c, s = np.cos(0.2), np.sin(0.2)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    xyz1 = (xyz0 @ R.T + np.array([1.0, 0.5, 0.0], np.float32)).astype(np.float32)
    f0 = rng.standard_normal((n, 32)).astype(np.float32)
    f1 = f0 + 0.1 * rng.standard_normal((n, 32)).astype(np.float32)
    f1[: n // 2] = rng.standard_normal((n // 2, 32))
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    reg = DGRRegistrar(dgr_kitti_config(max_points=16384), device="cuda", seed=3)
    eager = reg.chain(*reg.pad(xyz0, f0), *reg.pad(xyz1, f1))
    eager = {k: v.clone() for k, v in eager.items()}
    for _ in range(2):                  # the warm-up call, then the capture
        reg(xyz0, f0, xyz1, f1)
    before = (gather_gemm.launches_tcw, gather_gemm.launches_cin1,
              gather_gemm.launches_scalar, flash_nn.launches)
    got = reg.graphed(*reg.pad(xyz0, f0), *reg.pad(xyz1, f1))
    after = (gather_gemm.launches_tcw, gather_gemm.launches_cin1,
             gather_gemm.launches_scalar, flash_nn.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (20, 1, 0, 1)
    for k in eager:
        assert torch.equal(got[k], eager[k]), k
    out = reg(xyz0, f0, xyz1, f1)
    assert np.array_equal(out["transformation"], eager["transformation"].cpu().numpy())
    assert float(out["wsum"]) > 0
