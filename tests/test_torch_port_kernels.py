"""The port's CUDA kernels against their plain versions, on the card.

Kernels build with nvcc and run only on an NVIDIA GPU (sm_90a); every test
here carries the ``cuda`` marker and, without a card, skips (the fixture
decides, at run time). On the GPU machine:

    python -m pytest tests/test_torch_port_kernels.py -q
"""
import pytest
import torch

from imfnet_tpu_torch.match import nn_kernel
from imfnet_tpu_torch.match.nn_kernel import (NN_CHUNK_TILES, NN_MIN_TILES, NN_TILES, NNPlan,
                                                flash_nn, nn_plain, nn_plan)
from imfnet_tpu_torch.sparse.conv_kernel import (TC_TILES, ConvPlan, conv_plan,
                                                 gather_gemm, gather_gemm_plain, run_plan)
from imfnet_tpu_torch.sparse.quant_kernel import (INVALID_KEY, sorted_compact,
                                                  sorted_compact_plain)
from imfnet_tpu_torch.sparse.word_map_kernel import (MAX_PROBLEMS, word_match,
                                                     word_match_many, word_match_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _map(gen, n_in, n_out, k=27, miss=0.6):
    nbr = torch.randint(0, n_in, (n_out, k), generator=gen, device="cuda")
    drop = torch.rand((n_out, k), generator=gen, device="cuda") < miss
    return torch.where(drop, -1, nbr).to(torch.int32).contiguous()


def _prefix_map(gen, n_in, n_out):
    """Live rows first, then dead rows to the end, as in each pyramid level
    (a compacted prefix of its capacity): whole tiles at the end are dead."""
    nbr = _map(gen, n_in, n_out)
    nbr[n_out // 3:] = -1
    return nbr


def _one_offset_map(gen, n_in, n_out):
    """Only the centre offset is ever live: every tile walks one offset."""
    nbr = torch.full((n_out, 27), -1, dtype=torch.int32, device="cuda")
    nbr[:, 13] = _map(gen, n_in, n_out, k=1, miss=0.3)[:, 0]
    return nbr


MAPS = {"random": _map, "live prefix": _prefix_map, "one offset": _one_offset_map}

# the ten (cin, cout) pairs of the main path's convs, and a cin that is not a
# power of two
SHAPES = [(32, 32), (64, 64), (128, 128), (256, 256), (32, 64), (64, 128),
          (128, 256), (256, 128), (256, 64), (128, 64), (48, 40)]


def _variant_launches():
    return gather_gemm.launches_tc, gather_gemm.launches_scalar


@pytest.mark.parametrize("kind", list(MAPS))
@pytest.mark.parametrize("cin,cout", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_gemm_matches_plain(gen, cin, cout, dtype, kind):
    """Both sum exact products in f32, in another order: 1e-4 relative.
    900 output rows are no multiple of any tile, and the plan splits each
    of these shapes over offsets (few tiles). bf16 takes the tensor-core
    variant, f32 the scalar one; dead rows are exactly 0 and two calls
    give bit-equal output."""
    x = torch.randn((700, cin), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((27, cin, cout), generator=gen, device="cuda") * 0.05).to(dtype)
    nbr = MAPS[kind](gen, 700, 900)
    nbr[5] = -1
    nbr[-70:] = -1
    plan = conv_plan(900, cin, cout, 27, dtype)
    assert plan.variant == ("tc" if dtype == torch.bfloat16 else "scalar")
    assert plan.variant == "scalar" or plan.split > 1
    before = _variant_launches()
    out = gather_gemm(x, nbr, w)
    again = gather_gemm(x, nbr, w)
    ref = gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_variant_launches(), before))
    assert moved == ((2, 0) if plan.variant == "tc" else (0, 2))
    dead = (nbr < 0).all(dim=1)
    assert dead[5] and dead[-70:].all()
    assert (out[dead] == 0).all()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * max(1.0, ref.abs().max().item()))


@pytest.mark.parametrize("bm,bn,bk", sorted(TC_TILES))
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_gather_gemm_every_tile_and_split(gen, bm, bn, bk, split):
    """Every tensor-core instance the kernel has, at an explicit plan, on a
    live-prefix map with a ragged last tile."""
    x = torch.randn((3000, 64), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((27, 64, 136), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    nbr = _prefix_map(gen, 3000, 2500)
    plan = ConvPlan("tc", bm, bn, bk, split)
    out = run_plan(x, nbr, w, plan)
    again = run_plan(x, nbr, w, plan)
    ref = gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    assert (out[(nbr < 0).all(dim=1)] == 0).all()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * max(1.0, ref.abs().max().item()))


def test_gather_gemm_unsplit_at_level0_size(gen):
    """A level-0-sized call: enough tiles, so the plan does not split."""
    x = torch.randn((40000, 32), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((27, 32, 32), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    nbr = _prefix_map(gen, 40000, 65536)
    assert conv_plan(65536, 32, 32, 27, torch.bfloat16).split == 1
    out = gather_gemm(x, nbr, w)
    ref = gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    assert (out[(nbr < 0).all(dim=1)] == 0).all()
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * max(1.0, ref.abs().max().item()))


@pytest.mark.parametrize("k_vol,tile", [(125, (128, 64)), (343, (32, 32))])
def test_gather_gemm_wide_kernels(gen, k_vol, tile):
    """k5 (125 offsets) keeps the k3 tile of a 256-wide conv; k7 (343)
    narrows it until the map block fits shared memory. Both take tensor
    cores and match the plain version."""
    x = torch.randn((500, 256), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k_vol, 256, 256), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    nbr = _map(gen, 500, 600, k=k_vol, miss=0.8)
    nbr[-100:] = -1
    plan = conv_plan(600, 256, 256, k_vol, torch.bfloat16)
    assert plan.variant == "tc" and (plan.bn, plan.bk) == tile
    before = _variant_launches()
    out = gather_gemm(x, nbr, w)
    again = gather_gemm(x, nbr, w)
    ref = gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_variant_launches(), before)) == (2, 0)
    assert (out[-100:] == 0).all()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * max(1.0, ref.abs().max().item()))


@pytest.mark.parametrize("case", ["cin 20", "misaligned x"])
def test_gather_gemm_scalar_for_bf16_it_cannot_tile(gen, case):
    """bf16 with a width that is no multiple of 8, or an x that is not
    16-byte aligned, takes the scalar variant."""
    cin = 20 if case == "cin 20" else 32
    if case == "misaligned x":
        buf = torch.randn((700 * cin + 1,), generator=gen, device="cuda")
        x = buf.to(torch.bfloat16)[1:].view(700, cin)
        assert x.data_ptr() % 16 != 0
    else:
        x = torch.randn((700, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((27, cin, 24), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    nbr = _map(gen, 700, 900)
    before = _variant_launches()
    out = gather_gemm(x, nbr, w)
    ref = gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_variant_launches(), before)) == (0, 1)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * max(1.0, ref.abs().max().item()))


def test_gather_gemm_refuses_a_plan_that_does_not_fit(gen):
    x = torch.randn((50, 32), generator=gen, device="cuda")
    w = torch.randn((27, 32, 32), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="does not fit"):
        run_plan(x, _map(gen, 50, 60), w, ConvPlan("tc", 64, 64, 32, 1))


def test_gather_gemm_counts_launches(gen):
    x = torch.randn((50, 32), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((27, 32, 32), generator=gen, device="cuda").to(torch.bfloat16)
    before = gather_gemm.launches
    gather_gemm(x, _map(gen, 50, 60), w)
    assert gather_gemm.launches == before + 1


@pytest.mark.parametrize("d", [32, 3])
@pytest.mark.parametrize("valid_kind", ["all", "some", "one", "none"])
def test_flash_nn_matches_plain(gen, d, valid_kind):
    q = torch.randn((1000, d), generator=gen, device="cuda")
    r = torch.randn((1500, d), generator=gen, device="cuda")
    valid = {"all": torch.ones(1500, dtype=torch.bool, device="cuda"),
             "some": torch.rand(1500, generator=gen, device="cuda") > 0.3,
             "one": torch.arange(1500, device="cuda") == 777,
             "none": torch.zeros(1500, dtype=torch.bool, device="cuda")}[valid_kind]
    before = flash_nn.launches
    i_k, d_k = flash_nn(q, r, valid)
    i_p, d_p = nn_plain(q, r, valid)
    torch.cuda.synchronize()
    assert flash_nn.launches == before + 1
    assert torch.equal(i_k, i_p)
    if valid_kind == "none":
        assert (i_k == 0).all() and torch.isinf(d_k).all()
    else:
        torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-4)


# widths without a fold of their own (the chunk fold): model_n_out values
OTHER_WIDTHS = (1, 5, 8, 16, 24, 64, 256)


def _unit_rows(gen, k, d):
    """Unit rows, as descriptors are: d² below 4 at every width."""
    x = torch.randn((k, d), generator=gen, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("d", OTHER_WIDTHS)
@pytest.mark.parametrize("valid_kind", ["all", "some", "none"])
def test_flash_nn_at_any_width_matches_plain(gen, d, valid_kind):
    """Every D >= 1 launches the kernel (the chunk fold over D padded to a
    multiple of 8): indices equal the plain version's, d² within 1e-4, two
    calls bit-equal."""
    q, r = _unit_rows(gen, 1000, d), _unit_rows(gen, 1500, d)
    valid = {"all": torch.ones(1500, dtype=torch.bool, device="cuda"),
             "some": torch.rand(1500, generator=gen, device="cuda") > 0.3,
             "none": torch.zeros(1500, dtype=torch.bool, device="cuda")}[valid_kind]
    assert nn_plan(1000, 1500, d).fold == "chunk"
    before = flash_nn.launches
    i_k, d_k = flash_nn(q, r, valid)
    torch.cuda.synchronize()
    assert flash_nn.launches == before + 1
    if valid_kind == "none":
        assert (i_k == 0).all() and torch.isinf(d_k).all()
    else:   # at D = 1 unit rows are +-1: true ties, the lowest index wins
        _assert_nn_equal(q, r, valid)


def test_the_chunk_fold_at_d32_equals_the_pair_fold_bit_for_bit(gen):
    """The same f32 dots, summed over the same components in the same
    order by fmaf, folded and merged alike: at D = 32 the chunk fold's
    results are the pair fold's, bit for bit, at every split."""
    q = torch.randn((700, 32), generator=gen, device="cuda")
    r = torch.randn((1500, 32), generator=gen, device="cuda")
    valid = torch.rand(1500, generator=gen, device="cuda") > 0.2
    for split in (1, 3, 8):
        i_c, d_c = nn_kernel.run_plan(q, r, valid, NNPlan(64, 128, 128, split, "chunk"))
        i_p, d_p = nn_kernel.run_plan(q, r, valid, NNPlan(64, 128, 128, split, "pair"))
        assert torch.equal(i_c, i_p) and torch.equal(d_c, d_p)


def test_flash_nn_rejects_other_widths(gen):
    """Any D >= 1 launches (test_flash_nn_at_any_width_matches_plain); a
    width of 0 has nothing to search and raises."""
    with pytest.raises(ValueError, match="serves D"):
        flash_nn(torch.zeros((4, 0), device="cuda"), torch.zeros((5, 0), device="cuda"))


def _assert_nn_equal(q, r, valid, plan=None):
    """Kernel B (in ``plan``, else its shape's) equals the plain version:
    indices exactly (Gaussian inputs have no near-ties), d² within 1e-4
    (the same f32 terms summed in another order), two calls bit-equal."""
    plan = plan or nn_plan(q.shape[0], r.shape[0], q.shape[1])
    i_k, d_k = nn_kernel.run_plan(q, r, valid, plan)
    i_2, d_2 = nn_kernel.run_plan(q, r, valid, plan)
    i_p, d_p = nn_plain(q, r, valid)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_2) and torch.equal(d_k, d_2)
    assert torch.equal(i_k, i_p)
    finite = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d_k), finite)
    torch.testing.assert_close(d_k[finite], d_p[finite], rtol=0, atol=1e-4)


@pytest.mark.parametrize("d,fold,bq,br,threads",
                         [(32, "pair", *t) for t in sorted(NN_TILES)]
                         + [(3, "min", *t) for t in sorted(NN_MIN_TILES)]
                         + [(d, "chunk", *t) for t in sorted(NN_CHUNK_TILES)
                            for d in (16, 64)])
@pytest.mark.parametrize("split", [1, 2, 3, 4, 5, 6, 7, 8])
def test_flash_nn_every_tile_and_split(gen, bq, br, threads, split, d, fold):
    """Every instance the kernel has (the pair fold at D = 32, the min fold
    at D = 3, the chunk fold at D = 16 and 64), at an explicit plan, on sizes that are no multiple of a tile;
    with 1500 references the wider splits of a 128-wide tile leave parts
    with two tiles or one."""
    q = torch.randn((700, d), generator=gen, device="cuda")
    r = torch.randn((1500, d), generator=gen, device="cuda")
    valid = torch.rand(1500, generator=gen, device="cuda") > 0.2
    _assert_nn_equal(q, r, valid, NNPlan(bq, br, threads, split, fold))


@pytest.mark.parametrize("n", [1, 31, 129, 4999, 5003])
@pytest.mark.parametrize("m", [1, 31, 129, 4999, 5003])
@pytest.mark.parametrize("d", [32, 3, 16])
def test_flash_nn_ragged_sizes(gen, n, m, d):
    """Sizes around and below one tile, with a mask and with none; at
    m < 128 most parts of the split have no tile at all."""
    q = torch.randn((n, d), generator=gen, device="cuda")
    r = torch.randn((m, d), generator=gen, device="cuda")
    valid = torch.rand(m, generator=gen, device="cuda") > 0.1
    _assert_nn_equal(q, r, None if n < m else valid)


@pytest.mark.parametrize("d", [32, 3, 16, 64])
def test_flash_nn_ties_go_to_the_lowest_index(gen, d):
    """Every reference twice: both copies give bit-equal distances, and the
    kernel takes the first, whichever thread, tile or part holds it."""
    q = torch.randn((5000, d), generator=gen, device="cuda")
    half = torch.randn((2500, d), generator=gen, device="cuda")
    i_k, d_k = flash_nn(q, torch.cat([half, half]))
    i_p, d_p = nn_plain(q, half)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["last tile", "first part", "all but the last"])
def test_flash_nn_invalid_tiles_and_parts(gen, kind):
    """Whole tiles and whole parts of the split without a valid reference."""
    q = torch.randn((5000, 32), generator=gen, device="cuda")
    r = torch.randn((5000, 32), generator=gen, device="cuda")
    j = torch.arange(5000, device="cuda")
    valid = {"last tile": j < 4992, "first part": j >= 1664,
             "all but the last": j == 4999}[kind]
    assert nn_plan(5000, 5000, 32).part_ranges(5000)[0][1] <= 1664
    _assert_nn_equal(q, r, valid)


def test_flash_nn_no_references(gen):
    q = torch.randn((300, 32), generator=gen, device="cuda")
    idx, d2 = flash_nn(q, torch.zeros((0, 32), device="cuda"))
    torch.cuda.synchronize()
    assert (idx == 0).all() and torch.isinf(d2).all()
    idx, d2 = flash_nn(q[:0], q)
    assert idx.shape == (0,) and d2.shape == (0,)


def test_flash_nn_refuses_a_plan_without_an_instance(gen):
    q = torch.randn((50, 32), generator=gen, device="cuda")
    for plan in (NNPlan(256, 128, 256, 1), NNPlan(128, 128, 512, 1),
                 NNPlan(128, 128, 256, 9), NNPlan(128, 128, 256, 0),
                 NNPlan(128, 128, 256, 1, "min")):
        with pytest.raises(ValueError, match="no kernel instance"):
            nn_kernel.run_plan(q, q, None, plan)
    q3 = q[:, :3].contiguous()     # the pair fold is not built at D = 3
    with pytest.raises(ValueError, match="no kernel instance"):
        nn_kernel.run_plan(q3, q3, None, NNPlan(64, 128, 128, 1))
    with pytest.raises(ValueError, match="no kernel instance"):   # a tile the chunk fold lacks
        nn_kernel.run_plan(q, q, None, NNPlan(64, 64, 256, 1, "chunk"))


def _sorted_stream(gen, n, n_keys, invalid):
    key = torch.randint(0, n_keys, (n,), generator=gen, device="cuda")
    drop = torch.rand((n,), generator=gen, device="cuda") < invalid
    key = torch.where(drop, INVALID_KEY, key)
    return torch.sort(key, stable=True)


# (rows, distinct keys, invalid share, n_out): duplicates and invalid rows
# across tile edges, capacity overflow, all invalid, a ragged last tile, one
# row, more slots than rows, and the main path's raw-row count
COMPACT_CASES = [(4096, 700, 0.1, 1024), (4096, 3000, 0.0, 512), (2048, 10, 1.0, 64),
                 (5000, 1 << 40, 0.05, 8192), (1, 5, 0.0, 4), (3000, 50, 0.2, 0),
                 (262144, 1 << 22, 0.4, 65536)]


@pytest.mark.parametrize("n,n_keys,invalid,n_out", COMPACT_CASES)
def test_sorted_compact_matches_plain(gen, n, n_keys, invalid, n_out):
    sk, order = _sorted_stream(gen, n, n_keys, invalid)
    before = sorted_compact.launches
    sel, count = sorted_compact(sk, order, n_out)
    ref_sel, ref_count = sorted_compact_plain(sk, order, n_out)
    torch.cuda.synchronize()
    assert sorted_compact.launches == before + 1
    assert sel.dtype == torch.int64 and count.dtype == torch.int32
    assert torch.equal(sel, ref_sel) and torch.equal(count, ref_count)


def _edge_stream(kind, n):
    """A sorted stream of n rows whose runs are known by construction."""
    rows = torch.arange(n, device="cuda")
    if kind == "all invalid":
        sk = torch.full((n,), INVALID_KEY, device="cuda")
    elif kind == "one run":
        sk = torch.full((n,), 7, device="cuda")
    elif kind == "every row its own run":
        sk = rows * 3
    else:   # runs of three, the last tenth invalid
        sk = torch.where(rows < n - n // 10, rows // 3, INVALID_KEY)
    return sk.contiguous(), torch.flip(rows, (0,)).contiguous()


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
@pytest.mark.parametrize("kind", ["all invalid", "one run", "every row its own run",
                                  "runs of three"])
@pytest.mark.parametrize("slots", ["enough", "too few"])
def test_sorted_compact_tile_edges(gen, n, kind, slots):
    sk, order = _edge_stream(kind, n)
    n_out = n + 3 if slots == "enough" else max(n // 7, 1)
    sel, count = sorted_compact(sk, order, n_out)
    ref_sel, ref_count = sorted_compact_plain(sk, order, n_out)
    torch.cuda.synchronize()
    assert torch.equal(sel, ref_sel) and torch.equal(count, ref_count)


def test_sorted_compact_misaligned_keys(gen):
    """Keys that start 8 bytes off a 16-byte line take the scalar loads."""
    sk, order = _sorted_stream(gen, 5001, 900, 0.1)
    sk, order = sk[1:], order[1:].contiguous()
    assert sk.data_ptr() % 16 == 8 and sk.is_contiguous()
    sel, count = sorted_compact(sk, order, 2048)
    ref_sel, ref_count = sorted_compact_plain(sk, order, 2048)
    assert torch.equal(sel, ref_sel) and torch.equal(count, ref_count)


def test_sorted_compact_back_to_back_calls(gen):
    """The scratch is never reset between calls: calls in a row on one
    stream, at two sizes in turn, stay exact."""
    streams = [_sorted_stream(gen, n, k, 0.2) for n, k in ((262144, 1 << 20), (5000, 300))]
    refs = [sorted_compact_plain(sk, order, 4096) for sk, order in streams]
    outs = [sorted_compact(*streams[i % 2], 4096) for i in range(50)]
    torch.cuda.synchronize()
    for i, (sel, count) in enumerate(outs):
        assert torch.equal(sel, refs[i % 2][0]) and torch.equal(count, refs[i % 2][1]), i


def test_sorted_compact_in_a_replayed_graph(gen):
    """A captured call is one kernel node whose arguments are frozen; 100
    replays, with eager calls at the same size in between, stay exact."""
    sk, order = _sorted_stream(gen, 262144, 1 << 20, 0.3)
    ref_sel, ref_count = sorted_compact_plain(sk, order, 65536)
    sorted_compact(sk, order, 65536)          # warm-up: builds, leaves spares
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [sorted_compact(sk, order, 65536) for _ in range(3)]
    for i in range(100):
        for sel, count in outs:
            sel.fill_(-7)
            count.fill_(-7)
        graph.replay()
        if i % 10 == 0:
            eager = sorted_compact(sk, order, 65536)
            assert torch.equal(eager[0], ref_sel) and torch.equal(eager[1], ref_count)
        for sel, count in outs:
            assert torch.equal(sel, ref_sel) and torch.equal(count, ref_count), i


def test_sorted_compact_needs_an_eager_call_before_capture(gen):
    sk, order = _sorted_stream(gen, 7 * 1024 + 5, 100, 0.0)   # a size of its own
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside the capture"):
        with torch.cuda.graph(graph):
            sorted_compact(sk, order, 128)


def test_sorted_compact_on_two_streams(gen):
    """Each stream owns a scratch, so calls on two streams may overlap."""
    sk, order = _sorted_stream(gen, 262144, 1 << 21, 0.1)
    ref_sel, ref_count = sorted_compact_plain(sk, order, 65536)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for i in range(40):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(sorted_compact(sk, order, 65536))
    torch.cuda.synchronize()
    for sel, count in outs:
        assert torch.equal(sel, ref_sel) and torch.equal(count, ref_count)


def test_sorted_compact_rejects_wrong_dtypes(gen):
    sk, order = _sorted_stream(gen, 100, 10, 0.0)
    with pytest.raises(TypeError):
        sorted_compact(sk.int(), order, 10)
    with pytest.raises(TypeError):
        sorted_compact(sk, order.int(), 10)


def _word_table(gen, m):
    """Sorted keys with runs of one or two entries, the second of a pair
    zero, like compact_words' anchor/companion pairs."""
    step = torch.randint(1, 4, (m,), generator=gen, device="cuda")
    pair = torch.rand((m,), generator=gen, device="cuda") < 0.3
    step = torch.where(pair & (torch.arange(m, device="cuda") > 0), 0, step)
    keys = (torch.cumsum(step, 0) - 1).to(torch.int32)
    payload = torch.randint(-(1 << 31), (1 << 31) - 1, (m, 4), generator=gen,
                            device="cuda", dtype=torch.int64).to(torch.int32)
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device="cuda"), keys[1:] == keys[:-1]])
    payload[dup] = 0
    return keys.contiguous(), payload.contiguous()


@pytest.mark.parametrize("m,shape", [(2048, (512, 9)), (262144, (65536, 25)),
                                     (1, (7, 3)), (5000, (1000,))])
def test_word_match_matches_plain(gen, m, shape):
    keys, payload = _word_table(gen, m)
    hi = int(keys[-1]) + 3
    q = torch.randint(-3, hi, shape, generator=gen, device="cuda", dtype=torch.int32)
    before = word_match_many.launches
    out = word_match(keys, payload, q)
    ref = word_match_plain(keys, payload, q)
    torch.cuda.synchronize()
    assert word_match_many.launches == before + 1
    assert out.shape == (*shape, 4) and out.dtype == torch.int32
    assert torch.equal(out, ref)
    assert (out[q < 0] == 0).all()


def _padded_table(gen, m, used):
    """A table of ``m`` entries of which ``used`` are in use, the rest
    padding (largest key, zero payload), and the device scalar ``used``."""
    if m == 0:
        return (torch.zeros((0,), dtype=torch.int32, device="cuda"),
                torch.zeros((0, 4), dtype=torch.int32, device="cuda"),
                torch.tensor(0, dtype=torch.int32, device="cuda"))
    keys, payload = _word_table(gen, m)
    keys[used:] = 0x7FFFFFFF
    payload[used:] = 0
    return keys, payload, torch.tensor(used, dtype=torch.int32, device="cuda")


# (table entries, entries in use or None for all, query shape): map-shaped
# queries (k5, k3: one thread a (row, dx) group), flat and odd shapes (one
# thread a query), no query, an empty table, a table with nothing in use
MANY_CASES = [(262144, 70000, (65536, 25)), (40000, None, (21845, 9)),
              (2048, 2048, (512, 9)), (5000, 1, (1000,)), (64, 10, (0, 9)),
              (0, None, (40, 9)), (300, 0, (33, 25)), (1, None, (7, 3)),
              (4096, 3000, (50, 4, 9))]


def _many_problems(gen, cases):
    problems = []
    for m, used, shape in cases:
        keys, payload, n_words = _padded_table(gen, m, m if used is None else used)
        hi = int(keys[:int(n_words)].max()) + 3 if int(n_words) else 10
        q = torch.randint(-3, hi, shape, generator=gen, device="cuda", dtype=torch.int32)
        # sorted rows too, as a map's dy columns are: the gallop's usual case
        if len(shape) == 2 and shape[0]:
            q[::2] = q[::2].sort(dim=1).values
        problems.append((keys, payload, None if used is None else n_words, q))
    return problems


def test_word_match_many_matches_plain(gen):
    """One launch for all problems; each equals its plain version."""
    problems = _many_problems(gen, MANY_CASES)
    before = word_match_many.launches
    outs = word_match_many(problems)
    torch.cuda.synchronize()
    assert word_match_many.launches == before + 1
    for (keys, payload, _, q), out in zip(problems, outs):
        assert out.shape == (*q.shape, 4) and out.dtype == torch.int32
        assert torch.equal(out, word_match_plain(keys, payload, q))


def test_word_match_many_takes_more_problems_than_one_launch_holds(gen):
    cases = [(512 + 7 * i, None, (40 + i, 9)) for i in range(2 * MAX_PROBLEMS + 3)]
    problems = _many_problems(gen, cases)
    before = word_match_many.launches
    outs = word_match_many(problems)
    torch.cuda.synchronize()
    assert word_match_many.launches == before + 3
    for (keys, payload, _, q), out in zip(problems, outs):
        assert torch.equal(out, word_match_plain(keys, payload, q))


def test_word_match_many_without_queries_launches_nothing(gen):
    keys, payload = _word_table(gen, 64)
    before = word_match_many.launches
    (out,) = word_match_many([(keys, payload, None, keys[:0].reshape(0, 9))])
    assert out.shape == (0, 9, 4) and word_match_many.launches == before


def test_word_match_rejects_wrong_dtypes(gen):
    keys, payload = _word_table(gen, 64)
    q = keys[:8].contiguous()
    with pytest.raises(TypeError):
        word_match(keys.long(), payload, q)
    with pytest.raises(TypeError):
        word_match(keys, payload.float(), q)
    with pytest.raises(TypeError):
        word_match(keys, payload, q.long())
