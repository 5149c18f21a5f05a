"""Port parity, the packed-grid path: compact word tables, the kernel maps
of both pyramid builders (the search builder's and the banded one's), the
plain versions of kernels C (sorted-run compaction) and D (word-table
match), ``quantize_grid`` with ``compact_impl="kernel"``,
``build_pyramid_grid`` and the grid path of ``PairRegistrar``, against the
JAX package on the same numpy inputs (its Pallas kernels in interpret
mode; its dense "packed" map is the reference of every per-map case).
Every output here is an integer table and must be equal, except the
descriptors of the last test, which run the same CPU ops on equal tables
and must be bit-identical too."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.sparse import grid as jgrid
from imfnet_tpu.sparse.pallas_quant import BIG, sorted_compact as jax_sorted_compact
from imfnet_tpu.sparse.pallas_word_map import plan_word_windows, word_match_planned

from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.pipeline import PairRegistrar, bench_config
from imfnet_tpu_torch.sparse import grid as tgrid
from imfnet_tpu_torch.sparse.coords import PAD_COORD
from imfnet_tpu_torch.sparse.kernel_map import (build_pyramid, kernel_map_down,
                                                kernel_map_same, kernel_map_up)
from imfnet_tpu_torch.sparse.quant_kernel import (INVALID_KEY, sorted_compact,
                                                  sorted_compact_plain)
from imfnet_tpu_torch.sparse.word_map_kernel import (query_group, word_match,
                                                     word_match_many, word_match_plain)
from imfnet_tpu_torch.train.step import make_pyramid_fn

EXTENT = (64, 64, 64)
SPEC_J = jgrid.GridSpec(extent=EXTENT, num_batches=2)
SPEC_T = tgrid.GridSpec(extent=EXTENT, num_batches=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _table(rng, n_pad, level, n_real):
    """A scan-ordered unique level table of two batches at stride 2^level,
    padded to n_pad rows (the tables of tests/test_banded_map.py)."""
    stride = 1 << level
    parts = []
    for bi in (0, 1):
        pts = np.unique(rng.randint(0, 64 // stride, (n_real, 3)) * stride, axis=0)
        parts.append(np.concatenate([np.full((len(pts), 1), bi), pts], 1))
    c = np.concatenate(parts).astype(np.int32)
    key = ((c[:, 0].astype(np.int64) * 200 + c[:, 1]) * 200 + c[:, 2]) * 200 + c[:, 3]
    c = c[np.argsort(key, kind="stable")]
    n = min(len(c), n_pad)
    out = np.full((n_pad, 4), PAD_COORD, np.int32)
    out[:n] = c[:n]
    return out, n


# the (level, kernel, mode) cases of tests/test_banded_map.py::test_banded_matches_packed
MAP_CASES = [(0, 3, "same"), (0, 5, "same"), (1, 3, "same"), (2, 3, "same"),
             (0, 3, "down"), (1, 3, "down"), (1, 3, "up"), (2, 3, "up")]


@functools.lru_cache(maxsize=None)
def _map_case(lvl, kernel, mode):
    """Table, queries and origins of one map case, and JAX's packed map."""
    rng = np.random.RandomState(100 * lvl + 10 * kernel + len(mode))
    tab, n_t = _table(rng, 1024, lvl, 400)
    tv = np.arange(1024) < n_t
    if mode == "same":
        qc, qv = tab, tv
    elif mode == "down":
        qc, n_q = _table(rng, 512, lvl + 1, 150)
        qv = np.arange(512) < n_q
    else:
        qc, n_q = _table(rng, 2048, lvl - 1, 700)
        qv = np.arange(2048) < n_q
    allc = np.concatenate([tab, qc]) if mode != "same" else tab
    allv = np.concatenate([tv, qv]) if mode != "same" else tv
    origins = np.asarray(jgrid.batch_origins(jnp.asarray(allc), jnp.asarray(allv), 2))
    pt = jgrid.pack_level(jnp.asarray(tab), jnp.asarray(tv), jnp.asarray(origins),
                          SPEC_J, lvl)
    nbr = jgrid.packed_offset_map(pt, jnp.asarray(origins), jnp.asarray(qc),
                                  jnp.asarray(qv), SPEC_J, table_level=lvl,
                                  kernel_size=kernel, mode=mode)
    return dict(tab=tab, tv=tv, qc=qc, qv=qv, allc=allc, allv=allv,
                origins=origins, nbr=np.asarray(nbr))


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_compact_words_equal_jax(lvl):
    """The compact table with JAX's f32 16-bit halves reassembled
    (``_t6_to_t4``), and its counts and sorted flag."""
    case = _map_case(lvl, 3, "same")
    args_j = (jnp.asarray(case["tab"]), jnp.asarray(case["tv"]),
              jnp.asarray(case["origins"]), SPEC_J, lvl)
    args_t = (_t(case["tab"]), _t(case["tv"]), _t(case["origins"]), SPEC_T, lvl)
    wj, wt = jgrid.compact_words(*args_j), tgrid.compact_words(*args_t)
    np.testing.assert_array_equal(wt.wkeys.numpy(), np.asarray(wj.wkeys))
    np.testing.assert_array_equal(wt.payload.numpy(),
                                  np.asarray(jgrid._t6_to_t4(wj.payload)))
    assert int(wt.n_words) == int(wj.n_words) > 0
    assert bool(wt.sorted_ok) and bool(wj.sorted_ok)
    # every key at most twice: kernel D sums the entries at lower_bound and
    # the one after
    _, counts = np.unique(wt.wkeys.numpy()[: int(wt.n_words)], return_counts=True)
    assert counts.max() <= 2


@pytest.mark.parametrize("extent", [(64, 64, 64), (64, 64, 40), (20, 64, 64)])
def test_fits_grid_equals_jax(extent):
    table, n = _table(np.random.RandomState(6), 1024, 0, 400)
    table[:n // 2, 3] += 10            # z spans 0..73: 64 cells do not hold it
    spec_j = jgrid.GridSpec(extent=extent, num_batches=2)
    spec_t = tgrid.GridSpec(extent=extent, num_batches=2)
    for count in (n, 0):
        assert tgrid.fits_grid(table, count, spec_t) == jgrid.fits_grid(table, count, spec_j)
    assert not tgrid.fits_grid(table, n, spec_t)
    assert tgrid.fits_grid(table, n, tgrid.GridSpec(extent=(64, 64, 74)))


@pytest.mark.parametrize("impl", ["search", "banded"])
@pytest.mark.parametrize("lvl,kernel,mode", MAP_CASES)
def test_offset_maps_equal_jax_packed(impl, lvl, kernel, mode):
    """Each builder's map of one (level, kernel, mode) case against the JAX
    package's packed map."""
    case = _map_case(lvl, kernel, mode)
    origins = _t(case["origins"])
    np.testing.assert_array_equal(
        tgrid.batch_origins(_t(case["allc"]), _t(case["allv"]), 2).numpy(),
        case["origins"])
    tab, tv = _t(case["tab"]), _t(case["tv"])
    kw = dict(table_level=lvl, kernel_size=kernel, mode=mode)
    qc, qv = _t(case["qc"]), _t(case["qv"])
    if impl == "search":
        if mode == "same":
            nbr = kernel_map_same(tab, tv, kernel, 1 << lvl)
        elif mode == "down":
            nbr = kernel_map_down(tab, tv, qc, qv, kernel, 1 << lvl)
        else:
            nbr = kernel_map_up(tab, tv, qc, qv, kernel, 1 << (lvl - 1))
    else:
        wt = tgrid.compact_words(tab, tv, origins, SPEC_T, lvl)
        nbr = tgrid.banded_offset_map(wt, origins, qc, qv, SPEC_T, **kw)
    assert nbr.dtype == torch.int32 and nbr.shape == (len(case["qc"]), kernel ** 3)
    np.testing.assert_array_equal(nbr.numpy(), case["nbr"])
    assert (nbr >= 0).sum() > 0


@pytest.mark.parametrize("lvl,kernel,mode", [(0, 3, "same"), (0, 5, "same"),
                                             (0, 3, "down"), (1, 3, "up")])
def test_word_match_plain_equals_pallas_kernel(lvl, kernel, mode):
    """Kernel D's plain version against the TPU kernel (interpret mode) with
    one window over the whole table, on the real queries of a map plus
    random keys (present, absent and negative)."""
    case = _map_case(lvl, kernel, mode)
    args = (jnp.asarray(case["tab"]), jnp.asarray(case["tv"]),
            jnp.asarray(case["origins"]), SPEC_J, lvl)
    wj = jgrid.compact_words(*args)
    cols = list(jgrid._offset_columns(
        jnp.asarray(case["origins"]), jnp.asarray(case["qc"]), jnp.asarray(case["qv"]),
        SPEC_J, table_level=lvl, kernel_size=kernel, mode=mode))
    q = np.asarray(jnp.stack([jnp.where(c["ok_xy"], c["w0"], -2) for c in cols], 1))
    rng = np.random.RandomState(7)
    keys = np.asarray(wj.wkeys)
    extra = np.stack([rng.choice(keys[keys != BIG], q.shape[1]),
                      rng.randint(-5, int(keys[keys != BIG].max()) + 5, q.shape[1]),
                      np.full(q.shape[1], -1)])
    q = np.concatenate([q, extra]).astype(np.int32)
    width = -(-keys.shape[0] // 128) * 128
    q_pad, starts, exact = plan_word_windows(wj.wkeys, jnp.asarray(q), 128, width)
    assert bool(exact)
    t6 = word_match_planned(wj.wkeys, wj.payload, q_pad, starts, block=128,
                            width=width, interpret=True)[: q.shape[0]]
    ref = np.asarray(jgrid._t6_to_t4(t6))
    payload = _t(np.asarray(jgrid._t6_to_t4(wj.payload)))
    out = word_match_plain(_t(keys), payload, _t(q))
    assert out.dtype == torch.int32 and out.shape == (*q.shape, 4)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != 0).any() and (ref[-1] == 0).all()
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(word_match(_t(keys), payload, _t(q)).numpy(), ref)


def _word_problem(rng, m, shape, used=None, negative=False):
    """A sorted table of ``m`` entries (keys once or twice, the second of a
    pair with a zero payload; entries from ``used`` on are padding) and
    queries of ``shape``: present, absent and negative keys."""
    base = np.cumsum(rng.randint(1, 4, m))
    keys = np.repeat(base, rng.randint(1, 3, m))[:m].astype(np.int32)
    payload = rng.randint(-(1 << 31), 1 << 31, (m, 4)).astype(np.int32)
    payload[1:][keys[1:] == keys[:-1]] = 0
    n_words = None
    if used is not None:
        keys[used:] = tgrid.WORD_PAD
        payload[used:] = 0
        n_words = torch.tensor(used, dtype=torch.int32)
    hi = int(keys[:m if used is None else used].max(initial=5)) + 3
    q = rng.randint(-3, hi, shape).astype(np.int32)
    if negative:
        q = -1 - np.abs(q)
    return _t(keys), _t(payload), n_words, _t(q)


MANY_CASES = {
    "k5 map": dict(m=900, shape=(300, 25), used=700),
    "k3 map": dict(m=500, shape=(257, 9)),
    "flat": dict(m=300, shape=(1000,), used=1),
    "no queries": dict(m=64, shape=(0, 9), used=10),
    "empty table": dict(m=0, shape=(40, 9)),
    "nothing in use": dict(m=300, shape=(33, 25), used=0),
    "all keys negative": dict(m=128, shape=(50, 9), negative=True),
    "three axes": dict(m=400, shape=(20, 4, 9), used=400),
}


def test_word_match_many_on_cpu_equals_plain_per_problem():
    rng = np.random.RandomState(11)
    problems = [_word_problem(rng, **kw) for kw in MANY_CASES.values()]
    before = word_match_many.launches
    outs = word_match_many(problems)
    assert word_match_many.launches == before      # no kernel on the CPU
    assert len(outs) == len(problems)
    for name, (keys, payload, _, q), out in zip(MANY_CASES, problems, outs):
        assert out.dtype == torch.int32 and out.shape == (*q.shape, 4), name
        assert torch.equal(out, word_match_plain(keys, payload, q)), name
        # every key twice at most, so no hit beyond the first two entries
        assert torch.equal(out, _word_match_loop(keys, payload, q)), name
    assert (outs[list(MANY_CASES).index("all keys negative")] == 0).all()
    assert (outs[0] != 0).any()
    assert word_match_many([]) == []


def _word_match_loop(keys, payload, q):
    """The definition, entry by entry: Σ payload[j] over keys[j] == q."""
    table = {}
    for k, p in zip(keys.tolist(), payload.tolist()):
        table[k] = [(a + b + (1 << 31)) % (1 << 32) - (1 << 31)
                    for a, b in zip(table.get(k, [0, 0, 0, 0]), p)]
    flat = [table.get(k, [0, 0, 0, 0]) if k >= 0 else [0, 0, 0, 0]
            for k in q.reshape(-1).tolist()]
    return torch.tensor(flat, dtype=torch.int32).reshape(*q.shape, 4)


@pytest.mark.parametrize("shape,group", [((65536, 25), 5), ((100, 9), 3), ((20, 4, 9), 3),
                                         ((0, 9), 3), ((1000,), 1), ((7, 3), 1),
                                         ((5, 49), 1), ((9,), 1), ((25,), 1)])
def test_query_group_follows_the_map_columns(shape, group):
    """A kernel map's 9 or 25 columns are k groups of k dy columns; any other
    query tensor is matched one query a lane."""
    assert query_group(shape) == group
    assert int(np.prod(shape)) % group ** 2 == 0


def test_word_match_many_checks_every_problem():
    rng = np.random.RandomState(12)
    keys, payload, _, q = _word_problem(rng, m=64, shape=(8, 9))
    with pytest.raises(TypeError):
        word_match_many([(keys, payload, None, q), (keys, payload, None, q.long())])
    with pytest.raises(ValueError, match="n_words"):
        word_match_many([(keys, payload, torch.tensor(3), q)])
    with pytest.raises(ValueError, match="n_words"):
        word_match_many([(keys, payload, torch.tensor([3], dtype=torch.int32), q)])
    with pytest.raises(ValueError, match="share a device"):
        word_match_many([(keys, payload, None, q),
                         (keys.to("meta"), payload.to("meta"), None, q.to("meta"))])


@pytest.mark.parametrize("conv1_kernel_size,num_levels,maps", [(5, 4, 10), (3, 4, 10),
                                                               (5, 2, 4)])
def test_banded_build_calls_the_grouped_entry_once(monkeypatch, conv1_kernel_size,
                                                   num_levels, maps):
    """All maps of a pyramid go to kernel D's grouped entry in one call,
    each with its table's count of entries in use."""
    calls = []

    def counting(problems):
        calls.append(list(problems))
        return word_match_many(problems)

    monkeypatch.setattr(tgrid, "word_match_many", counting)
    table, n = _table(np.random.RandomState(8), 1024, 0, 300)
    pyr = tgrid.build_pyramid_grid(_t(table), torch.tensor(n, dtype=torch.int32),
                                   spec=SPEC_T, num_levels=num_levels,
                                   conv1_kernel_size=conv1_kernel_size,
                                   level_capacity=(1024, 512, 256, 256)[:num_levels])
    assert len(calls) == 1 and len(calls[0]) == maps
    k2 = conv1_kernel_size ** 2
    assert [q.shape[1] for *_, q in calls[0]] == [k2] + [9] * (maps - 1)
    assert all(n_words is not None and n_words.dtype == torch.int32
               for _, _, n_words, _ in calls[0])
    assert len(pyr.levels) == num_levels
    calls.clear()
    build_pyramid(_t(table), torch.tensor(n, dtype=torch.int32),
                  level_capacity=(1024, 512, 256, 256))
    assert calls == []


def _compact_case(name, rng):
    if name == "dups_and_invalids":
        n, n_out = 4096, 1024
        key = np.where(rng.rand(n) < 0.1, BIG, rng.randint(0, 700, n))
    elif name == "overflow":
        n, n_out = 4096, 512
        key = rng.randint(0, 3000, n)
    elif name == "all_invalid":
        n, n_out = 2048, 64
        key = np.full(n, BIG)
    else:   # 27-bit keys
        n, n_out = 2048, 2048
        key = rng.randint(0, 1 << 27, n)
    return key.astype(np.int32), n_out


@pytest.mark.parametrize("name", ["dups_and_invalids", "overflow", "all_invalid",
                                  "27bit_keys"])
def test_sorted_compact_plain_equals_pallas_kernel(name):
    """Kernel C's plain version against the TPU kernel (interpret mode) on
    the same stable-sorted stream; the port's sentinels are int64 max for
    an invalid key and -1 for an empty slot where the TPU kernel has BIG."""
    key, n_out = _compact_case(name, np.random.RandomState(0))
    order = np.argsort(key, kind="stable")
    sk = key[order]
    sel_j, nv_j = jax_sorted_compact(jnp.asarray(sk), jnp.asarray(order.astype(np.int32)),
                                     n_out, interpret=True)
    sk_t = torch.from_numpy(np.where(sk == BIG, INVALID_KEY, sk.astype(np.int64)))
    order_t = torch.from_numpy(order.astype(np.int64))
    for fn in (sorted_compact_plain, sorted_compact):
        sel, nv = fn(sk_t, order_t, n_out)
        assert sel.dtype == torch.int64 and sel.shape == (n_out,)
        assert nv.dtype == torch.int32 and int(nv) == int(nv_j)
        sel_j = np.asarray(sel_j)
        np.testing.assert_array_equal(sel.numpy()[: int(nv)], sel_j[: int(nv)])
        assert (sel.numpy()[int(nv):] == -1).all() and (sel_j[int(nv):] == BIG).all()


@pytest.mark.parametrize("n_out", [1024, 300])
def test_quantize_grid_kernel_equals_jax_pallas(n_out):
    """n = 4096 is a multiple of 2048, so JAX takes its Pallas branch."""
    rng = np.random.RandomState(1)
    n = 4096
    xyz = (rng.rand(n, 3) * 1.2).astype(np.float32)
    valid = rng.rand(n) < 0.9
    bidx = (rng.rand(n) < 0.5).astype(np.int32)
    feats = rng.randn(n, 3).astype(np.float32)
    sv_j, sel_j, xd_j = jgrid.quantize_grid(
        jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(valid), 0.05, n_out, SPEC_J,
        batch_index=jnp.asarray(bidx), compact_impl="pallas")
    outs = [tgrid.quantize_grid(_t(xyz), _t(feats), _t(valid), 0.05, n_out, SPEC_T,
                                batch_index=_t(bidx), compact_impl=impl)
            for impl in ("kernel", "auto")]
    for sv_t, sel_t, xd_t in outs:
        assert int(sv_t.num_valid) == int(sv_j.num_valid)
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
        np.testing.assert_array_equal(sv_t.coords.numpy(), np.asarray(sv_j.coords))
        np.testing.assert_array_equal(sv_t.feats.numpy(), np.asarray(sv_j.feats))
        np.testing.assert_array_equal(xd_t.numpy(), np.asarray(xd_j))
    if n_out == 300:
        assert int(outs[0][0].num_valid) == 300
    with pytest.raises(ValueError, match="compact_impl"):
        tgrid.quantize_grid(_t(xyz), _t(feats), _t(valid), 0.05, n_out, SPEC_T,
                            compact_impl="pallas")
    with pytest.raises(ValueError, match="compact_impl"):
        PairRegistrar(device="cpu", compact_impl="pallas")


CAPS = (2048, 683, 256, 256)


@pytest.fixture(scope="module")
def pyramid_input():
    table, n = _table(np.random.RandomState(3), 2048, 0, 700)
    pyr_j = jax.jit(lambda c, nv: jgrid.build_pyramid_grid(
        c, nv, spec=SPEC_J, level_capacity=CAPS, map_impl="packed"))(
        jnp.asarray(table), jnp.int32(n))
    return table, n, pyr_j


def _pyramid_tables(pyr):
    out = {"k5_l0": pyr.k5_l0}
    for i, lv in enumerate(pyr.levels):
        out[f"num_valid{i}"] = lv.num_valid
        for name in ("coords", "k3_same", "down", "up"):
            if getattr(lv, name) is not None:
                out[f"{name}{i}"] = getattr(lv, name)
    return {k: np.asarray(v) for k, v in out.items()}


def test_build_pyramid_grid_equals_jax_and_search(pyramid_input):
    table, n, pyr_j = pyramid_input
    pyr_t = tgrid.build_pyramid_grid(_t(table), torch.tensor(n, dtype=torch.int32),
                                     spec=SPEC_T, level_capacity=CAPS)
    pyr_s = build_pyramid(_t(table), torch.tensor(n, dtype=torch.int32),
                          level_capacity=CAPS)
    got, want, search = (_pyramid_tables(p) for p in (pyr_t, pyr_j, pyr_s))
    assert got.keys() == want.keys() == search.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], search[k], err_msg=k)
    assert pyr_t.k5_l0.is_contiguous() and pyr_t.levels[0].k3_same.is_contiguous()


def test_build_pyramid_grid_conv1_k3():
    """conv1 k3 shares its map with the level-0 k3; a kernel wider than the
    2-cell halo holds is refused."""
    table, n = _table(np.random.RandomState(4), 1024, 0, 300)
    nv = torch.tensor(n, dtype=torch.int32)
    caps = (1024, 512, 256, 256)
    want = _pyramid_tables(build_pyramid(_t(table), nv, conv1_kernel_size=3,
                                         level_capacity=caps))
    pyr = tgrid.build_pyramid_grid(_t(table), nv, spec=SPEC_T, conv1_kernel_size=3,
                                   level_capacity=caps)
    assert pyr.k5_l0 is pyr.levels[0].k3_same
    got = _pyramid_tables(pyr)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="conv1_kernel_size"):
        tgrid.build_pyramid_grid(_t(table), nv, spec=SPEC_T, conv1_kernel_size=7)


def test_make_pyramid_fn_grid_builders_equal_search():
    table, n = _table(np.random.RandomState(5), 2048, 0, 600)
    cfg = bench_config()
    nv = torch.tensor(n, dtype=torch.int32)
    want, got = (_pyramid_tables(make_pyramid_fn(cfg, 2048, 2, extent=EXTENT,
                                                 map_impl=impl)(_t(table), nv))
                 for impl in ("search", "banded"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="map_impl"):
        make_pyramid_fn(cfg, 2048, map_impl="dense")


def test_unsorted_word_table_raises():
    case = _map_case(0, 3, "same")
    origins, tab, tv = _t(case["origins"]), _t(case["tab"]), _t(case["tv"])
    wt = tgrid.compact_words(tab, tv, origins, SPEC_T, 0)
    q = wt.wkeys[:8].reshape(2, 4).contiguous()
    flipped = wt._replace(wkeys=wt.wkeys.flip(0).contiguous(),
                          sorted_ok=(wt.wkeys.flip(0)[1:] >= wt.wkeys.flip(0)[:-1]).all())
    with pytest.raises(RuntimeError, match="not sorted"):
        tgrid.banded_word_t4_many([(flipped, q)])
    # a level table out of scan order gives an unsorted word table
    n = int(tv.sum())
    shuffled = tab.clone()
    shuffled[:n] = tab[:n].flip(0)
    wt_bad = tgrid.compact_words(shuffled, tv, origins, SPEC_T, 0)
    assert not bool(wt_bad.sorted_ok)
    with pytest.raises(RuntimeError, match="not sorted"):
        tgrid.banded_offset_map(wt_bad, origins, shuffled, tv, SPEC_T, table_level=0,
                                kernel_size=3, mode="same")


def test_kernel_c_d_wrappers_check_inputs():
    sk = torch.arange(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        sorted_compact(sk.int(), sk, 4)
    with pytest.raises(ValueError):
        sorted_compact(sk, sk[:5], 4)
    with pytest.raises(ValueError):
        sorted_compact(sk[::2], sk[::2], 4)
    with pytest.raises(ValueError, match="unsupported device"):
        sorted_compact(sk.to("meta"), sk.to("meta"), 4)
    keys = torch.arange(6, dtype=torch.int32)
    payload = torch.zeros((6, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        word_match(keys.long(), payload, keys)
    with pytest.raises(TypeError):
        word_match(keys, payload.float(), keys)
    with pytest.raises(ValueError):
        word_match(keys, payload[:, :3], keys)
    with pytest.raises(ValueError):
        word_match(keys, payload, keys.reshape(2, 3).t())
    with pytest.raises(ValueError, match="unsupported device"):
        word_match(keys.to("meta"), payload.to("meta"), keys.to("meta"))


@pytest.fixture(scope="module")
def registrars():
    """The default path and the packed-grid path on one small pair, CPU
    (divisors under which this sparse cloud's coarse levels fit)."""
    cfg = bench_config().replace(compute_dtype="float32",
                                 level_capacity_divisors=(1, 2, 4, 8))
    pair = synthetic_pair(np.random.RandomState(2), n_points=6000, image_hw=(24, 32))
    out = {}
    for name, kw in (("default", {}),
                     ("grid", dict(compact_impl="kernel", map_impl="banded"))):
        reg = PairRegistrar(cfg, device="cpu", seed=1, **kw)
        pb = reg.prepare(pair.xyz0, pair.xyz1, pair.image0, pair.image1)
        q = reg.quantize(pb)
        pyr = reg.pyramid(q)
        out[name] = (q, pyr, reg.forward(q, pyr, pb.images))
    return out


def test_registrar_grid_path_equals_default(registrars):
    (qd, pd, fd), (qg, pg, fg) = registrars["default"], registrars["grid"]
    assert qg.spec == qd.spec
    assert int(qg.sv.num_valid) == int(qd.sv.num_valid) > 0
    assert int(qg.n0) == int(qd.n0)
    assert torch.equal(qg.sv.coords, qd.sv.coords)
    assert torch.equal(qg.xyz_down, qd.xyz_down)
    got, want = _pyramid_tables(pg), _pyramid_tables(pd)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # equal tables and inputs run the same CPU ops: bit-identical descriptors
    assert torch.equal(fg, fd)
