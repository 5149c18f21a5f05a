"""Kernel E, the 6-D kernel-map builder (``csrc/map6.cu``), on the card
(``cuda`` marker; each test skips without one). The file imports no JAX.

Against its plain version (``kernel_map.offset_map6_plain``, the chunked
``searchsorted`` chain, run on the card): all 10 maps of a 6-D pyramid at
``kitti-dgr-pair``'s shape (131 072 rows, about 67 000 valid), tables whose
keys crowd a few buckets, empty and full tables, rows out of the key's range,
keys at the range's ends in batches 0-3; one CUDA graph replayed on two
tables; the tally ``map6.queries`` / ``map6.probes`` against the CPU's
emulation (``map6_kernel.map6_many`` on CPU tensors); one launch a pyramid;
``eval.dgr.DGRRegistrar``'s graph against its eager call.

    python3 -m pytest tests/test_torch_port_map6_card.py -q -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from imfnet_tpu_torch.sparse import coords as C
from imfnet_tpu_torch.sparse import kernel_map as KM
from imfnet_tpu_torch.sparse.map6_kernel import map6_many
from imfnet_tpu_torch.utils import timer

pytestmark = pytest.mark.cuda
CELL_ROWS, CELL_VALID = 131_072, 67_000     # kitti-dgr-pair's padding and voxels a side
NAMES = ("k3_same", "down", "up")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel E is built with nvcc and runs only on the card")


def dgr_coords(n, seed, inliers=0.3):
    """int32[n, 7]: DGR-like correspondences (0, floor(p / 0.3), floor(q /
    0.3)) of n voxels over a 40 m disc, the target the source under a yaw
    and 11 m, a share of them matched to their true point, the rest to a
    random one."""
    rng = np.random.default_rng(seed)
    m = 2 * n
    r, a = 40 * np.sqrt(rng.random(m)), 2 * np.pi * rng.random(m)
    xyz = np.c_[r * np.cos(a), r * np.sin(a), 3 * rng.random(m) - 1.5].astype(np.float32)
    _, first = np.unique(np.floor(xyz / np.float32(0.3)).astype(np.int64), axis=0,
                         return_index=True)
    p = xyz[np.sort(first)][:n]
    c, s = np.cos(0.15), np.sin(0.15)
    q = p @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32).T + 11.0
    wrong = rng.random(len(p)) >= inliers
    q[wrong] = q[rng.integers(0, len(p), int(wrong.sum()))]
    cells = np.floor(np.c_[p, q] / np.float32(0.3)).astype(np.int32)
    return np.c_[np.zeros(len(p), np.int32), cells]


def table_of(c, n_pad):
    """(coords int32[n_pad, 7] sorted and unique, num_valid) on the card."""
    t = torch.from_numpy(np.ascontiguousarray(c)).cuda()
    ok = torch.ones(len(c), dtype=torch.bool, device="cuda")
    if len(c) < n_pad:
        t = torch.cat([t, torch.full((n_pad - len(c), 7), C.PAD_COORD, dtype=torch.int32,
                                     device="cuda")])
        ok = torch.cat([ok, torch.zeros(n_pad - len(c), dtype=torch.bool, device="cuda")])
    uniq, _, n = C.unique_voxels(t, ok, n_pad)
    return uniq, n


def pyramid(table, n, conv1=3):
    return KM.build_pyramid(table, n, conv1_kernel_size=conv1,
                            level_capacity=(table.shape[0],) * 4)


def plain_maps(pyr):
    """{(name, level): the plain chain's map} of a 6-D pyramid's tables."""
    valid = [C.row_mask(lv.coords.shape[0], lv.num_valid) for lv in pyr.levels]
    out = {}
    for i, lv in enumerate(pyr.levels):
        t = 2 ** i
        for name, src, s in (("k3_same", i, t), ("down", i - 1, t // 2), ("up", i + 1, t)):
            if 0 <= src < len(pyr.levels):
                out[name, i] = KM.offset_map6_plain(
                    lv.coords, valid[i], pyr.levels[src].coords, valid[src],
                    KM.offsets_on(3, s, "cuda", 6))
    return out


def assert_maps_equal(pyr, want):
    assert len(want) == 10
    for (name, i), m in want.items():
        got = getattr(pyr.levels[i], name)
        assert got.dtype == torch.int32 and got.shape == m.shape, (name, i)
        diff = int((got != m).sum())
        assert diff == 0, f"{name} of level {i}: {diff} entries differ"


def test_pyramid_maps_equal_the_plain_chain_at_the_cells_shape(card):
    table, n = table_of(dgr_coords(CELL_VALID, 0), CELL_ROWS)
    before = map6_many.launches
    pyr = pyramid(table, n)
    assert map6_many.launches == before + 1
    assert pyr.k5_l0 is pyr.levels[0].k3_same
    assert pyr.levels[0].k3_same.shape == (CELL_ROWS, 729)
    assert 60_000 < int(n) <= CELL_VALID
    assert_maps_equal(pyr, plain_maps(pyr))
    live = sum(int((m >= 0).sum()) for m in plain_maps(pyr).values())
    assert live > int(n)               # more than the centre offsets alone


def _crowded(seed):
    """Rows sharing their first five fields, so that their keys share a
    prefix and home bucket: 40 prefixes of up to 300 rows (last two axes
    over a 15 x 15 square), chains of tens of full buckets."""
    rng = np.random.default_rng(seed)
    heads = np.c_[np.zeros(40, np.int64), rng.integers(-20, 20, (40, 4))]
    tails = rng.integers(-7, 8, (40, 300, 2))
    c = np.concatenate([np.c_[np.repeat(heads[i:i + 1], 300, 0), tails[i]] for i in range(40)])
    return np.unique(c, axis=0).astype(np.int32)


def _ends(seed):
    """Rows at the ends of the key's range (``KEY6_MARGIN`` from each end of
    an axis) in batches 0-3."""
    rng = np.random.default_rng(seed)
    ends = np.array([-504, -503, -496, 495, 502, 503])
    c = np.c_[rng.integers(0, 4, 4000), rng.choice(ends, (4000, 6))]
    return np.unique(c, axis=0).astype(np.int32)


@pytest.mark.parametrize("kind", ["crowded", "ends", "empty", "full", "tiny"])
def test_pyramid_maps_equal_the_plain_chain_on_edge_tables(card, kind):
    if kind == "crowded":
        table, n = table_of(_crowded(1), 32_768)
    elif kind == "ends":
        table, n = table_of(_ends(2), 8192)
    elif kind == "empty":
        table, n = table_of(np.zeros((0, 7), np.int32), 4096)
    elif kind == "full":
        c = dgr_coords(6000, 3)
        table, n = table_of(c, len(c))
        assert int(n) == table.shape[0]
    else:
        table, n = table_of(dgr_coords(3, 4), 3)
    pyr = pyramid(table, n)
    assert_maps_equal(pyr, plain_maps(pyr))


def test_rows_out_of_range_and_padding_give_minus_ones(card):
    """A table whose valid rows end in rows out of the key's range (their
    keys are sentinels: never found, never probed), then padding."""
    inside = np.unique(np.c_[np.zeros(3000, np.int64),
                             np.random.default_rng(5).integers(-4, 4, (3000, 6))],
                       axis=0).astype(np.int32)
    outside = np.array([[0, 504, 0, 0, 0, 0, 0], [4, 0, 0, 0, 0, 0, 0],
                        [0, 0, 0, 0, 0, 0, -505]], np.int32)
    c = torch.from_numpy(np.r_[inside, outside, np.full((509, 7), C.PAD_COORD, np.int32)]).cuda()
    valid = torch.arange(c.shape[0], device="cuda") < len(inside) + len(outside)
    offs = KM.offsets_on(3, 1, "cuda", 6)
    got = KM.offset_map6(c, valid, c, valid, offs)
    want = KM.offset_map6_plain(c, valid, c, valid, offs)
    assert torch.equal(got, want)
    assert bool((got[len(inside):] == -1).all())
    assert bool((got[:len(inside), 364] == torch.arange(len(inside), device="cuda")).all())


def test_one_graph_replayed_on_two_tables_gives_each_its_maps(card):
    n_pad = 16_384
    tables = [table_of(dgr_coords(8000, s), n_pad) for s in (6, 7)]
    static_c, static_n = tables[0][0].clone(), tables[0][1].clone()
    pyramid(static_c, static_n)                      # built before the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pyramid(static_c, static_n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = map6_many.launches
    with torch.cuda.graph(graph):
        pyr = pyramid(static_c, static_n)
    assert map6_many.launches == before + 1
    for table, n in tables[::-1] + tables:
        static_c.copy_(table)
        static_n.copy_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert_maps_equal(pyr, plain_maps(pyramid(table, n)))


def _emulated(pyr):
    """{(name, level): map} and the counters of ``map6_many`` on CPU
    copies of a 6-D pyramid's tables: the kernel's hash in plain PyTorch."""
    keys = [C.make_keys(lv.coords, C.row_mask(lv.coords.shape[0], lv.num_valid),
                        is_table=True).cpu() for lv in pyr.levels]
    unit = KM.key_deltas(KM.offsets_on(3, 1, "cpu", 6))
    problems, names = [], []
    for i in range(len(keys)):
        for name, src, s in (("k3_same", i, 2 ** i), ("down", i - 1, 2 ** i // 2),
                             ("up", i + 1, 2 ** i)):
            if 0 <= src < len(keys):
                problems.append((i, src, unit, s))
                names.append((name, i))
    timer.reset()
    with timer.tracing():
        maps = map6_many(keys, problems)
        counts = timer.record()["counters"]
    timer.reset()
    return dict(zip(names, maps)), counts


def test_counters_match_the_emulation(card):
    table, n = table_of(dgr_coords(2000, 8), 4096)
    timer.reset()
    with timer.tracing():
        pyr = pyramid(table, n)
        got = timer.record()["counters"]
    timer.reset()
    maps, want = _emulated(pyr)
    for (name, i), m in maps.items():
        assert torch.equal(getattr(pyr.levels[i], name).cpu(), m), (name, i)
    for k in ("map6.queries", "map6.probes"):
        assert got[k] == want[k], k
    rows = [int(lv.num_valid) for lv in pyr.levels]
    assert got["map6.queries"] == 729 * (3 * sum(rows) - rows[0] - rows[-1])
    assert got["map6.queries"] <= got["map6.probes"] < 2 * got["map6.queries"]


def test_counters_are_read_once_a_traced_graph_replay(card):
    """Inside a capture the graph keeps the tally's words; each traced
    replay adds them, read with its stage times."""
    from imfnet_tpu_torch.utils.graphs import jit

    table, n = table_of(dgr_coords(2000, 9), 4096)
    fn = jit(lambda c, num: pyramid(c, num).levels[0].k3_same, clone=True)
    for _ in range(2):
        fn(table, n)
    timer.reset()
    with timer.tracing():
        fn(table, n)
        fn(table, n)
        got = timer.record()["counters"]
    timer.reset()
    timer.reset()
    with timer.tracing():
        pyramid(table, n)
        once = timer.record()["counters"]
    timer.reset()
    assert got["map6.queries"] == 2 * once["map6.queries"] > 0
    assert got["map6.probes"] == 2 * once["map6.probes"]


def test_launches_a_pyramid_and_a_map(card):
    table, n = table_of(dgr_coords(1000, 10), 2048)
    before = map6_many.launches
    pyramid(table, n)
    pyramid(table, n, conv1=5)          # conv1's own map in the same call
    valid = C.row_mask(table.shape[0], n)
    KM.offset_map6(table, valid, table, valid, KM.offsets_on(3, 1, "cuda", 6))
    assert map6_many.launches == before + 3
    three = torch.zeros((64, 4), dtype=torch.int32, device="cuda")
    KM.build_pyramid(three, torch.tensor(0, dtype=torch.int32, device="cuda"),
                     conv1_kernel_size=3)
    assert map6_many.launches == before + 3          # 3-D maps do not reach it


def test_conv1_k5_map_equals_the_plain_chain(card):
    table, n = table_of(dgr_coords(1500, 11), 2048)
    got = pyramid(table, n, conv1=5).k5_l0
    valid = C.row_mask(table.shape[0], n)
    want = KM.offset_map6_plain(table, valid, table, valid, KM.offsets_on(5, 1, "cuda", 6))
    assert got.shape == (2048, 5 ** 6) and torch.equal(got, want)


def test_inputs_on_two_devices_raise(card):
    keys = torch.zeros(8, dtype=torch.int64)
    deltas = torch.zeros(3, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="share one device"):
        map6_many([keys, keys.cuda()], [(0, 1, deltas, 1)])
    with pytest.raises(ValueError, match="share one device"):
        map6_many([keys], [(0, 0, deltas, 1)])


def test_registrar_graph_replays_its_eager_call(card):
    from imfnet_tpu_torch.config import dgr_kitti_config
    from imfnet_tpu_torch.eval.dgr import DGRRegistrar

    rng = np.random.default_rng(0)
    c = dgr_coords(6000, 12)
    xyz0 = (c[:, 1:4] * 0.3 + 0.15).astype(np.float32)
    xyz1 = (c[:, 4:7] * 0.3 + 0.15).astype(np.float32)
    f0 = rng.standard_normal((len(c), 32)).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    reg = DGRRegistrar(dgr_kitti_config(max_points=16384), device="cuda", seed=3)
    seen = []
    reg.model.register_forward_hook(lambda mod, inputs, out: seen.append(inputs[1]))
    eager = reg.chain(*reg.pad(xyz0, f0), *reg.pad(xyz1, f0))
    eager = {k: v.clone() for k, v in eager.items()}
    want = plain_maps(seen[-1])
    for _ in range(2):                  # the warm-up call, then the capture
        reg(xyz0, f0, xyz1, f0)
    before = map6_many.launches
    got = reg.graphed(*reg.pad(xyz0, f0), *reg.pad(xyz1, f0))
    assert map6_many.launches == before + 1
    for k in eager:
        assert torch.equal(got[k], eager[k]), k
    assert_maps_equal(seen[-1], want)
