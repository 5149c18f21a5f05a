"""Kernel E's hash, emulated in plain PyTorch on the CPU.

``sparse.map6_kernel.hash_plain`` and ``lookup_plain`` are the kernel's
hash (the same home bucket, slot layout and probe order); ``map6_many`` runs
them for CPU tensors. They are held bit for bit to the plain version of a
6-D map, ``kernel_map.offset_map6_plain`` (the chunked ``searchsorted``
chain), on random tables, tables whose keys crowd a few buckets, a hash
filled to its last slots, empty and full tables, padding and rows out of
the key's range, keys at the range's ends in batches 0-3, and each level's
same, down and up maps of a pyramid; the layout of another order of
insertion gives the same maps and probes. Also: the wrapper's input checks,
its scratch sizing, its tally. The kernel itself is held to the same chain
on the card (``test_torch_port_map6_card.py``).
"""
import itertools

import numpy as np
import pytest
import torch

from imfnet_tpu_torch.sparse import coords as C
from imfnet_tpu_torch.sparse import kernel_map as KM
from imfnet_tpu_torch.sparse import map6_kernel as M
from imfnet_tpu_torch.utils import timer

K3 = 729


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops, beside the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sorted(c, n_pad=None):
    """(coords int32[n_pad, 7] in key order, padded; valid bool[n_pad])."""
    c = np.unique(np.asarray(c, np.int64), axis=0).astype(np.int32)
    n_pad = len(c) if n_pad is None else n_pad
    t = torch.full((n_pad, 7), C.PAD_COORD, dtype=torch.int32)
    t[:len(c)] = torch.from_numpy(c)
    return t, torch.arange(n_pad) < len(c)


def _emulated(out_c, out_v, in_c, in_v, offsets, buckets=None, order=None):
    """(map, probes) of the kernel's hash at ``buckets`` (default the
    wrapper's), with the input's keys inserted in ``order`` of rows if
    given (a sequential build in that order)."""
    table = C.make_keys(in_c, in_v, is_table=True)
    rows = C.make_keys(out_c, out_v, is_table=False)
    buckets = M.hash_buckets(len(table)) if buckets is None else buckets
    hkeys, hrows = (M.hash_plain(table, buckets) if order is None
                    else _sequential_hash(table, buckets, order))
    live = (rows < C.PAD_QUERY_KEY)[:, None].expand(-1, len(offsets))
    q = torch.where(live, rows[:, None] + KM.key_deltas(offsets)[None], -1)
    return M.lookup_plain(hkeys, hrows, q, live)


def _sequential_hash(table, buckets, order):
    """The hash built one key at a time in the given order of rows, as a
    single thread of the kernel's insert would: the first free slot from
    the home on, an equal key keeping the least row."""
    hkeys = [-1] * (buckets * M.SLOTS)
    hrows = [-1] * (buckets * M.SLOTS)
    homes = M.home_bucket(table, buckets).tolist()
    for r in order:
        key = int(table[r])
        if key >= C.PAD_QUERY_KEY:
            continue
        b = homes[r]
        while True:
            done = False
            for s in range(M.SLOTS):
                at = b * M.SLOTS + s
                if hkeys[at] in (-1, key):
                    hkeys[at] = key
                    hrows[at] = r if hrows[at] < 0 else min(hrows[at], r)
                    done = True
                    break
            if done:
                break
            b = (b + 1) % buckets
    return torch.tensor(hkeys), torch.tensor(hrows)


def _random6(rng, n, lo, hi, batches=1):
    return np.c_[rng.integers(0, batches, n), rng.integers(lo, hi, (n, 6))]


def test_home_bucket_is_fibonacci_hashing_of_the_prefix():
    rng = np.random.default_rng(0)
    keys = [int(k) for k in rng.integers(0, 1 << 62, 200, dtype=np.int64)] + [0, 1, (1 << 62) - 1]
    for buckets in (2, 4, 1 << 10, 1 << 17, 1 << 28):
        got = M.home_bucket(torch.tensor(keys), buckets).tolist()
        log2 = buckets.bit_length() - 1
        want = [(((k >> M.DROP_BITS) * M.GOLDEN) % (1 << 64)) >> (64 - log2) for k in keys]
        assert got == want


@pytest.mark.parametrize("rows,buckets", [(0, 2), (1, 2), (2, 2), (3, 4), (4, 4), (5, 8),
                                          (131_072, 131_072), (131_073, 262_144)])
def test_hash_buckets_hold_four_slots_a_row(rows, buckets):
    assert M.hash_buckets(rows) == buckets
    assert M.SLOTS * buckets >= 4 * rows                  # a load of at most 0.25


def test_scratch_is_each_searched_tables_keys_and_rows():
    assert M.scratch_bytes([131_072] * 4) == 4 * 131_072 * M.SLOTS * 12   # 25.2 MB
    assert M.scratch_bytes([3, 131_073]) == (4 + 262_144) * M.SLOTS * 12
    assert M.scratch_bytes([]) == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_emulation_equals_the_chain_on_random_tables(seed):
    rng = np.random.default_rng(seed)
    out_c, out_v = _sorted(_random6(rng, 300, -4, 4), 384)
    in_c, in_v = _sorted(_random6(rng, 500, -4, 4), 640)
    for scale in (1, 2):
        offs = KM.offsets_on(3, scale, "cpu", 6)
        got, probes = _emulated(out_c, out_v, in_c, in_v, offs)
        want = KM.offset_map6_plain(out_c, out_v, in_c, in_v, offs)
        assert torch.equal(got, want)
        assert int((got >= 0).sum()) > 0
        assert bool((probes[~out_v] == 0).all()) and bool((probes[out_v] >= 1).all())


@pytest.mark.parametrize("kind", ["crowded", "last_slots"])
def test_emulation_equals_the_chain_under_collisions(kind):
    """"crowded": every key of the table shares one of three prefixes (the
    first five fields), so one home bucket each and chains of tens of full
    buckets; "last_slots": a hash of the fewest buckets that hold the
    table's keys, every bucket full but a few."""
    rng = np.random.default_rng(7)
    if kind == "crowded":
        heads = np.array([[0, 1, 2, 3, 4], [0, -3, 0, 5, 1], [0, 2, 2, 2, 2]])
        c = np.concatenate([np.c_[np.repeat(h[None], 150, 0), rng.integers(-6, 7, (150, 2))]
                            for h in heads])
        t, v = _sorted(c)
        buckets = None
    else:
        t, v = _sorted(_random6(rng, 400, -3, 3))
        buckets = max(2, 1 << (-(-int(v.sum()) // M.SLOTS) - 1).bit_length())
    offs = KM.offsets_on(3, 1, "cpu", 6)
    got, probes = _emulated(t, v, t, v, offs, buckets=buckets)
    assert torch.equal(got, KM.offset_map6_plain(t, v, t, v, offs))
    assert int(probes.max()) > 5                        # lookups walk long chains
    assert float(probes[v].float().mean()) > 1.5


def test_another_order_of_insertion_gives_the_same_maps_and_probes():
    rng = np.random.default_rng(8)
    t, v = _sorted(_random6(rng, 200, -2, 2))
    buckets = max(2, 1 << (-(-int(v.sum()) // M.SLOTS) - 1).bit_length())   # crowded
    offs = KM.offsets_on(3, 1, "cpu", 6)
    base = _emulated(t, v, t, v, offs, buckets=buckets)
    for seed in (0, 1):
        order = np.random.default_rng(seed).permutation(len(t)).tolist()
        other = _emulated(t, v, t, v, offs, buckets=buckets, order=order)
        assert torch.equal(other[0], base[0]) and torch.equal(other[1], base[1])
    hk_a, _ = M.hash_plain(C.make_keys(t, v, is_table=True), buckets)
    hk_b, _ = _sequential_hash(C.make_keys(t, v, is_table=True), buckets,
                               np.random.default_rng(2).permutation(len(t)).tolist())
    assert torch.equal(hk_a != -1, hk_b != -1)            # the same slots taken


@pytest.mark.parametrize("n_valid", [0, 1, 64])
def test_emulation_on_empty_and_full_tables(n_valid):
    rng = np.random.default_rng(9)
    c = np.unique(_random6(rng, 400, -3, 3), axis=0)[:n_valid] if n_valid else np.zeros((0, 7))
    t, v = _sorted(c, max(n_valid, 1) if n_valid else 16)
    assert int(v.sum()) == n_valid
    if n_valid:
        assert bool(v.all())                             # num_valid = the capacity
    offs = KM.offsets_on(3, 1, "cpu", 6)
    got, _ = _emulated(t, v, t, v, offs)
    assert torch.equal(got, KM.offset_map6_plain(t, v, t, v, offs))
    if n_valid:
        assert bool((got[:, K3 // 2] == torch.arange(n_valid)).all())


def test_padding_and_rows_out_of_range_give_minus_ones():
    rng = np.random.default_rng(10)
    inside, _ = _sorted(_random6(rng, 300, -3, 3))
    outside = torch.tensor([[0, 504, 0, 0, 0, 0, 0], [4, 0, 0, 0, 0, 0, 0],
                            [-1, 0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, -505, 0]], dtype=torch.int32)
    pad = torch.full((60, 7), C.PAD_COORD, dtype=torch.int32)
    t = torch.cat([inside, outside, pad])
    v = torch.arange(len(t)) < len(inside) + len(outside)
    offs = KM.offsets_on(3, 1, "cpu", 6)
    got, probes = _emulated(t, v, t, v, offs)
    assert torch.equal(got, KM.offset_map6_plain(t, v, t, v, offs))
    assert bool((got[len(inside):] == -1).all())
    assert int(probes[len(inside):].sum()) == 0          # sentinel rows probe nothing


@pytest.mark.parametrize("scale", [1, 8])
def test_keys_at_the_ends_of_the_range_in_batches_0_to_3(scale):
    rng = np.random.default_rng(11)
    ends = np.array([-504, -504 + scale, 503 - scale, 503]) // scale * scale
    c = np.c_[rng.integers(0, 4, 600), rng.choice(ends, (600, 6))]
    t, v = _sorted(c, 700)
    offs = KM.offsets_on(3, scale, "cpu", 6)
    got, _ = _emulated(t, v, t, v, offs)
    assert torch.equal(got, KM.offset_map6_plain(t, v, t, v, offs))
    assert int((got >= 0).sum()) > int(v.sum())           # neighbours across the ends


@pytest.mark.parametrize("seed", [0, 1])
def test_map6_many_gives_a_pyramids_same_down_and_up_maps(seed):
    """The wrapper on CPU tensors (the emulation), all ten maps of a 6-D
    pyramid in one call, against ``build_pyramid``'s maps on the CPU (the
    chain); each problem's queries are its live rows times 729."""
    rng = np.random.default_rng(seed)
    t, _ = _sorted(_random6(rng, 900, -9, 9), 1024)
    n = torch.tensor(int((t[:, 0] != C.PAD_COORD).sum()), dtype=torch.int32)
    pyr = KM.build_pyramid(t, n, conv1_kernel_size=3, level_capacity=(1024,) * 4)
    keys = [C.make_keys(lv.coords, C.row_mask(1024, lv.num_valid), is_table=True)
            for lv in pyr.levels]
    unit = KM.key_deltas(KM.offsets_on(3, 1, "cpu", 6))
    problems, names = [], []
    for i in range(4):
        for name, src, s in (("k3_same", i, 2 ** i), ("down", i - 1, 2 ** i // 2),
                             ("up", i + 1, 2 ** i)):
            if 0 <= src < 4:
                problems.append((i, src, unit, s))
                names.append((name, i))
    timer.reset()
    with timer.tracing():
        maps = M.map6_many(keys, problems)
        counts = timer.record()["counters"]
    timer.reset()
    assert len(maps) == 10
    for (name, i), m in zip(names, maps):
        assert torch.equal(m, getattr(pyr.levels[i], name)), (name, i)
    rows = [int(lv.num_valid) for lv in pyr.levels]
    assert counts["map6.queries"] == K3 * sum(rows[i] for i, *_ in problems)
    assert counts["map6.queries"] <= counts["map6.probes"] < 2 * counts["map6.queries"]


def test_key_deltas_are_the_offsets_keys():
    """A row's key plus an offset's delta is the key of the row plus the
    offset, for in-range rows and offsets within the margin."""
    rng = np.random.default_rng(12)
    c = torch.from_numpy(_random6(rng, 50, -400, 400, batches=4).astype(np.int32))
    offs = KM.offsets_on(3, 8, "cpu", 6)
    ok = torch.ones(len(c), dtype=torch.bool)
    base = C.make_keys(c, ok, is_table=True)
    moved = c[:, None, :].clone().expand(-1, len(offs), -1).clone()
    moved[..., 1:] += offs[None]
    want = C.make_keys(moved.reshape(-1, 7), ok.repeat_interleave(len(offs)), is_table=True)
    assert torch.equal((base[:, None] + KM.key_deltas(offs)[None]).reshape(-1), want)


def test_offset_map6_on_the_cpu_is_the_chain():
    rng = np.random.default_rng(13)
    t, v = _sorted(_random6(rng, 200, -3, 3), 256)
    offs = KM.offsets_on(3, 1, "cpu", 6)
    assert torch.equal(KM.offset_map6(t, v, t, v, offs), KM.offset_map6_plain(t, v, t, v, offs))
    got = KM.offset_maps6([(t, v)], [(0, 0, offs, 2), (0, 0, offs, 1)])
    assert torch.equal(got[0], KM.offset_map6_plain(t, v, t, v, offs * 2))
    assert torch.equal(got[1], KM.offset_map6_plain(t, v, t, v, offs))


def _keys(n=8):
    return torch.arange(n, dtype=torch.int64)


def _deltas(k=3):
    return torch.zeros(k, dtype=torch.int64)


@pytest.mark.parametrize("bad,error,match", [
    (lambda: ([_keys().to(torch.int32)], [(0, 0, _deltas(), 1)]), TypeError, "keys must be int64"),
    (lambda: ([_keys().reshape(2, 4)], [(0, 0, _deltas(), 1)]), ValueError, "keys must be 1-D"),
    (lambda: ([_keys(16)[::2]], [(0, 0, _deltas(), 1)]), ValueError, "keys must be contiguous"),
    (lambda: ([_keys()], [(0, 0, _deltas().to(torch.int32), 1)]), TypeError,
     "deltas must be int64"),
    (lambda: ([_keys()], [(0, 0, _deltas().reshape(3, 1), 1)]), ValueError, "deltas must be"),
    (lambda: ([_keys()], [(0, 0, _deltas(0), 1)]), ValueError, "deltas must be"),
    (lambda: ([_keys()], [(0, 0, _deltas(6)[::2], 1)]), ValueError,
     "deltas must be contiguous"),
    (lambda: ([_keys()], [(0, 1, _deltas(), 1)]), ValueError, "table index out of range"),
    (lambda: ([_keys()], [(-1, 0, _deltas(), 1)]), ValueError, "table index out of range"),
    (lambda: ([_keys()], [(0, 0, _deltas(), 1.0)]), TypeError, "scale must be an int"),
    (lambda: ([], []), ValueError, "no tables"),
    (lambda: ([_keys()], [(0, 0, _deltas(), 1)] * (M.MAX_PROBLEMS + 1)), ValueError,
     "at most 16 maps"),
    (lambda: ([_keys()] * 9, [(0, i, _deltas(), 1) for i in range(9)]), ValueError,
     "at most 8 tables searched"),
])
def test_map6_many_checks_its_inputs(bad, error, match):
    keys, problems = bad()
    with pytest.raises(error, match=match):
        M.map6_many(keys, problems)


def test_map6_many_with_no_maps_returns_none():
    assert M.map6_many([_keys()], []) == []


def test_map6_many_keeps_the_least_row_of_a_repeated_key():
    """A table whose key repeats (a sorted table that is not unique): the
    least row, as the chain's searchsorted left bound gives."""
    t, v = _sorted(_random6(np.random.default_rng(14), 100, -2, 2))
    t = torch.cat([t[:40], t[39:40], t[39:40], t[40:]])
    v = torch.ones(len(t), dtype=torch.bool)
    offs = KM.offsets_on(3, 1, "cpu", 6)
    want = KM.offset_map6_plain(t, v, t, v, offs)
    keys = C.make_keys(t, v, is_table=True)
    got = M.map6_many([keys], [(0, 0, KM.key_deltas(offs), 1)])[0]
    assert torch.equal(got, want)
    assert int((got == 40).sum()) == 0 and int((got == 39).sum()) > 0


def test_the_offsets_of_a_group_share_a_home_bucket():
    """The k3 offsets in product order: each run of 9 columns differs in
    the last two axes alone, so a row's queries of one run have one prefix
    and one home bucket (the kernel reads it once for the run)."""
    offs = np.array(list(itertools.product((-1, 0, 1), repeat=6)))
    assert (offs.reshape(81, 9, 6)[:, :, :4] == offs.reshape(81, 9, 6)[:, :1, :4]).all()
    rows = C.make_keys(torch.tensor([[0, 3, -7, 100, 4, 5, -6], [2, 0, 0, 0, 0, 0, 0]],
                                    dtype=torch.int32), torch.ones(2, dtype=torch.bool),
                       is_table=True)
    q = rows[:, None] + KM.key_deltas(torch.from_numpy(offs))[None]
    homes = M.home_bucket(q.reshape(-1), 1 << 17).reshape(2, 81, 9)
    assert bool((homes == homes[:, :, :1]).all())
    assert len(torch.unique(homes[0, :, 0])) > 70          # the runs spread over buckets
