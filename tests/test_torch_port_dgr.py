"""Deep Global Registration's 6-D path on the CPU, at small sizes.

The 6-D keys (lexicographic order, out-of-range rows flagged and never
aliased), the 6-D maps against a dictionary built by brute force, the 3-D
keys, tables and maps unchanged, kernel A's plan at 729 offsets, and the
6-D network and ``eval.dgr.DGRRegistrar``'s whole chain against the
benchmark's plain reference (``benchmark/reference/dgr.py``), which imports
nothing of the port. Kernel A's and B's CUDA kernels are held at the same
shapes on the card (``test_torch_port_dgr_card.py``).
"""
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from imfnet_tpu_torch.config import dgr_kitti_config
from imfnet_tpu_torch.eval.dgr import DGRRegistrar
from imfnet_tpu_torch.models.resunet import ResUNetIMF
from imfnet_tpu_torch.sparse import coords as C
from imfnet_tpu_torch.sparse import kernel_map as KM
from imfnet_tpu_torch.sparse.conv_kernel import conv_plan
from imfnet_tpu_torch.train.step import make_pyramid_fn

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib import weights as bench_weights  # noqa: E402
from reference import dgr as ref_dgr  # noqa: E402
from reference import voxels as ref_vox  # noqa: E402
from reference.precision import Precision  # noqa: E402

# f32 products on both sides; only the order of the f32 sums differs
LOGIT_TOL = 1e-4        # of the largest |logit|
POSE_TOL_M = 1e-4       # f32 Horn's method against the reference's f64 SVD, metres
SMALL = dict(channels=(8, 16, 16, 16), tr_channels=(8, 8, 8, 16))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: beside the
    other test workers a thread pool per process oversubscribes the cores,
    and its barriers then cost far more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows6(rng, n, lo=-6, hi=6, batches=1):
    c = np.c_[rng.integers(0, batches, n), rng.integers(lo, hi, (n, 6))]
    return np.unique(c, axis=0).astype(np.int32)


def _valid(n):
    return torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("seed", [0, 1])
def test_6d_keys_order_rows_as_a_lexicographic_sort(seed):
    rng = np.random.default_rng(seed)
    c = np.c_[rng.integers(0, 4, 3000), rng.integers(-504, 504, (3000, 6))].astype(np.int32)
    keys = C.make_keys(torch.from_numpy(c), _valid(len(c)), is_table=True)
    order = torch.argsort(keys, stable=True).numpy()
    want = np.lexsort(tuple(c[:, a] for a in reversed(range(7))))
    assert np.array_equal(c[order], c[want])
    assert len(torch.unique(keys)) == len(np.unique(c, axis=0))
    assert bool((keys < C.PAD_QUERY_KEY).all())


def test_6d_out_of_range_rows_are_flagged_never_aliased():
    inside = np.array([[0, 503, 0, 0, 0, 0, -504], [3, 0, 0, 0, 0, 0, 0]], np.int32)
    # the last two would alias in a 10-bit packing without its margin: 512
    # wraps to -512, and -513 borrows from the axis before
    outside = np.array([[0, 504, 0, 0, 0, 0, -504], [0, 0, 0, 0, 0, -505, 0],
                        [4, 0, 0, 0, 0, 0, 0], [-1, 0, 0, 0, 0, 0, 0],
                        [0, 512, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, -513, 0]], np.int32)
    c = torch.from_numpy(np.r_[inside, outside])
    assert C.in_key_range(c).tolist() == [True, True] + [False] * 6
    assert int(C.out_of_range(c, _valid(8))) == 6
    assert int(C.out_of_range(c, torch.tensor([True] * 2 + [False] * 6))) == 0
    table = C.make_keys(c, _valid(8), is_table=True)
    assert (table[2:] == C.PAD_TABLE_KEY).all()
    query = C.make_keys(c, _valid(8), is_table=False)
    assert (query[2:] == C.PAD_QUERY_KEY).all()
    t_sorted = torch.sort(C.make_keys(c[:2], _valid(2), is_table=True)).values
    assert C.lookup(t_sorted, query).tolist()[2:] == [-1] * 6


@pytest.mark.parametrize("scale,ends", [(1, [-504, -503, 502, 503]),
                                        (8, [-504, -496, 495, 503])])
def test_6d_maps_at_the_ends_of_the_key_range(scale, ends):
    """Rows at the ends of the range find their neighbours by key
    arithmetic, with no borrow or carry between axes: the map equals a
    dictionary's."""
    rng = np.random.default_rng(9)
    c = np.unique(np.c_[np.zeros(400, np.int64),
                        rng.choice(np.array(ends), (400, 6))], axis=0).astype(np.int32)
    t = torch.from_numpy(c[np.lexsort(tuple(c[:, a] for a in reversed(range(7))))])
    v = _valid(len(t))
    offs = KM.offsets_on(3, scale, "cpu", 6)
    got = KM.offset_map(t, v, t, v, offs)
    assert torch.equal(got, _brute_map(t.numpy(), t.numpy(), offs.numpy()))
    assert int((got >= 0).sum()) > len(t)
    with pytest.raises(ValueError, match="at most 4 levels"):
        KM.build_pyramid(t, torch.tensor(len(t), dtype=torch.int32), num_levels=5,
                         conv1_kernel_size=3)


def test_3d_keys_are_the_16_bit_packing():
    rng = np.random.default_rng(3)
    c = torch.from_numpy(np.c_[rng.integers(0, 3, 500),
                               rng.integers(-40000, 40000, (500, 3))].astype(np.int32))
    v = torch.from_numpy(rng.random(500) < 0.9)
    x = c.long()
    want = ((((x[:, 0] << 16) | ((x[:, 1] + 32768) & 0xFFFF)) << 32)
            | (((x[:, 2] + 32768) & 0xFFFF) << 16) | ((x[:, 3] + 32768) & 0xFFFF))
    for is_table, pad in ((True, C.PAD_TABLE_KEY), (False, C.PAD_QUERY_KEY)):
        got = C.make_keys(c, v, is_table=is_table)
        assert torch.equal(got, torch.where(v, want, torch.full_like(want, pad)))
    assert bool(C.in_key_range(c).all())


def _brute_map(out_c, in_c, offs):
    where = {tuple(r): i for i, r in enumerate(in_c.tolist())}
    return torch.tensor([[where.get(tuple(np.add(r, [0, *o])), -1) for o in offs]
                         for r in out_c.tolist()], dtype=torch.int32).reshape(len(out_c), -1)


def _pyramid6(c, n_pad, caps):
    t = torch.full((n_pad, 7), C.PAD_COORD, dtype=torch.int32)
    order = np.lexsort(tuple(c[:, a] for a in reversed(range(7))))
    t[:len(c)] = torch.from_numpy(c[order])
    return KM.build_pyramid(t, torch.tensor(len(c), dtype=torch.int32), conv1_kernel_size=3,
                            level_capacity=caps)


@pytest.mark.parametrize("seed", [0, 1])
def test_6d_maps_equal_a_dictionary(seed):
    c = _rows6(np.random.default_rng(seed), 150, -3, 3)
    pyr = _pyramid6(c, 192, (192, 192, 192, 192))
    assert pyr.k5_l0 is pyr.levels[0].k3_same          # conv1 k3 shares level 0's map
    tables = [c]
    for i in (1, 2, 3):
        s = np.c_[c[:, :1], np.floor_divide(c[:, 1:], 2 ** i) * 2 ** i]
        tables.append(np.unique(s, axis=0))
    for i, lv in enumerate(pyr.levels):
        n = int(lv.num_valid)
        assert n == len(tables[i])
        assert np.array_equal(lv.coords[:n].numpy(), tables[i])
        assert (lv.coords[n:] == C.PAD_COORD).all()
        t = 2 ** i
        offs = list(itertools.product((-t, 0, t), repeat=6))
        half = list(itertools.product((-t // 2, 0, t // 2), repeat=6)) if i else None
        for nbr, src, o in ((lv.k3_same, tables[i], offs),
                            (lv.down, tables[i - 1] if i else None, half),
                            (lv.up, tables[i + 1] if i < 3 else None, offs)):
            if src is None:
                assert nbr is None
                continue
            assert nbr.shape == (192, 729)
            assert torch.equal(nbr[:n], _brute_map(tables[i], src, o))
            assert bool((nbr[n:] == -1).all())


def test_6d_maps_do_not_depend_on_the_chunk(monkeypatch):
    c = _rows6(np.random.default_rng(5), 120, -2, 2)
    searches = []

    def counted(table, keys):
        searches.append(keys.numel())
        return lookup(table, keys)

    lookup = KM.lookup
    monkeypatch.setattr(KM, "lookup", counted)
    whole = _pyramid6(c, 128, (128, 128, 128, 128))
    n_whole, most = len(searches), max(searches)
    monkeypatch.setattr(KM, "MAP_CHUNK_ENTRIES", 128 * 50)
    chunked = _pyramid6(c, 128, (128, 128, 128, 128))
    assert len(searches) - n_whole > n_whole          # more, smaller searches
    assert max(searches[n_whole:]) <= 128 * 50 < most
    for a, b in zip(whole.levels, chunked.levels):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_3d_tables_and_maps_equal_the_plain_reference(seed):
    rng = np.random.default_rng(seed)
    c = np.unique(np.c_[rng.integers(0, 2, 1500), rng.integers(-12, 12, (1500, 3))],
                  axis=0).astype(np.int64)
    n_pad = 2048
    t = torch.full((n_pad, 4), C.PAD_COORD, dtype=torch.int32)
    t[:len(c)] = torch.from_numpy(c).to(torch.int32)
    pyr = KM.build_pyramid(t, torch.tensor(len(c), dtype=torch.int32), conv1_kernel_size=5,
                           level_capacity=(2048, 2048, 1024, 1024))
    ref = ref_vox.pyramid(torch.from_numpy(c), 4, 5)
    for i, lv in enumerate(pyr.levels):
        n = int(lv.num_valid)
        assert torch.equal(lv.coords[:n].long(), ref.tables[i])
        for got, want in ((lv.k3_same, ref.same[i]), (lv.down, ref.down[i]),
                          (lv.up, ref.up[i])):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got[:n].long(), want) and bool((got[n:] == -1).all())
    assert torch.equal(pyr.k5_l0[:len(c)].long(), ref.conv1)


def test_the_packed_grid_builders_stay_3d():
    cfg = dgr_kitti_config(max_points=256)
    with pytest.raises(ValueError, match="3-D"):
        make_pyramid_fn(cfg, 256, map_impl="banded", dim=6)
    make_pyramid_fn(cfg, 256, map_impl="search", dim=6)


@pytest.mark.parametrize("cin,cout", [(8, 8), (32, 32), (64, 128), (128, 64), (256, 256)])
def test_plan_at_729_offsets_takes_tensor_cores(cin, cout):
    for n_out in (128, 65536, 131072):
        plan = conv_plan(n_out, cin, cout, 3 ** 6, torch.bfloat16)
        assert plan.variant == "tcw" and plan.bm == 128
    assert conv_plan(131072, 1, 32, 3 ** 6, torch.bfloat16) == ("cin1", 32, 32, 1, 1)


def test_published_widths_name_the_reference_parameters():
    m = dict(channels=[32, 64, 128, 256], tr_channels=[64, 64, 64, 128], in_channels=1,
             out_channels=1, conv1_kernel_size=3)
    with torch.device("meta"):
        model = ResUNetIMF(dim=6, in_channels=1, out_channels=1, conv1_kernel_size=3,
                           normalize_feature=False, with_image=False)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {name: shape for name, shape, _, _ in ref_dgr.param_specs(m)}
    assert got == want
    params = sum(v.numel() for v in model.parameters())
    assert 235e6 < params < 237e6
    assert sum(v.numel() for k, v in model.named_parameters() if k.startswith("block4.")) \
        == 2 * 729 * 256 * 256 + 4 * 256


def _small_pair(rng, n=300, outliers=150):
    xyz = (rng.random((10 * n, 3)) * 4).astype(np.float32)
    _, first = np.unique(np.floor(xyz / np.float32(0.3)).astype(np.int64), axis=0,
                         return_index=True)
    xyz0 = xyz[np.sort(first)][:n]
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    xyz1 = (xyz0 @ R.T + [0.5, 0.2, 0.1]).astype(np.float32)
    f0 = rng.standard_normal((len(xyz0), 32)).astype(np.float32)
    f1 = f0 + 0.3 * rng.standard_normal(f0.shape).astype(np.float32)
    f1[rng.permutation(len(f1))[:outliers]] = rng.standard_normal((outliers, 32))
    return xyz0, f0, xyz1, f1


def _small_model(seed):
    m = dict(in_channels=1, out_channels=1, conv1_kernel_size=3,
             **{k: list(v) for k, v in SMALL.items()})
    P = bench_weights.make(ref_dgr.param_specs(m), seed, "cpu")
    model = ResUNetIMF(dim=6, in_channels=1, out_channels=1, conv1_kernel_size=3,
                       normalize_feature=False, with_image=False,
                       compute_dtype=torch.float32, **SMALL)
    model.load_state_dict(P)
    return model, P


@pytest.mark.parametrize("seed", [0, 1])
def test_6d_forward_matches_the_reference(seed):
    xyz0, _, xyz1, _ = _small_pair(np.random.default_rng(seed))
    nn = torch.from_numpy(np.random.default_rng(seed + 7).permutation(len(xyz1)))
    c = ref_dgr.correspondences(torch.from_numpy(xyz0), torch.from_numpy(xyz1), nn, 0.3)
    ref_pyr = ref_dgr.pyramid(c[ref_dgr.lex_sort(c)])
    model, P = _small_model(seed)
    pyr = _pyramid6(c.numpy().astype(np.int32), 384, (384,) * 4)
    n = len(c)
    sv = C.SparseVoxels(pyr.levels[0].coords, (torch.arange(384) < n)[:, None].float(),
                        pyr.levels[0].num_valid)
    with torch.no_grad():
        got = model.eval()(sv, pyr, None)[:, 0]
    want = ref_dgr.logits(P, ref_pyr, Precision("f32"))
    assert float((got[:n] - want).abs().max()) <= LOGIT_TOL * float(want.abs().max())
    assert bool((got[n:] == 0).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_registrar_chain_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    xyz0, f0, xyz1, f1 = _small_pair(rng)
    model, P = _small_model(seed)
    seen = []
    model.register_forward_hook(lambda mod, inputs, out: seen.append(inputs))
    reg = DGRRegistrar(dgr_kitti_config(max_points=512), device="cpu", model=model)
    out = reg.chain(*reg.pad(xyz0, f0), *reg.pad(xyz1, f1))
    n = len(xyz0)
    nn = out["nn"][:n]
    want_nn = torch.cdist(torch.from_numpy(f0), torch.from_numpy(f1)).argmin(dim=1)
    assert torch.equal(nn, want_nn)
    ref = ref_dgr.register(P, torch.from_numpy(xyz0), torch.from_numpy(xyz1), nn, 0.3,
                           reg.clip_weight_thresh, Precision("f32"))
    sv, pyr, _ = seen[-1]
    assert torch.equal(sv.coords[:n].long(), ref.table)
    got_maps = [m for lv in pyr.levels for m in (lv.k3_same, lv.down, lv.up) if m is not None]
    for got, (_, want) in zip(got_maps, ref_dgr.maps(ref.pyr), strict=True):
        assert torch.equal(got[:len(want)].long(), want)
    order = ref_dgr.lex_sort(ref_dgr.correspondences(torch.from_numpy(xyz0),
                                                     torch.from_numpy(xyz1), nn, 0.3))
    logits = out["logits"][:n][order]
    assert float((logits - ref.logits).abs().max()) <= LOGIT_TOL * float(ref.logits.abs().max())
    assert torch.allclose(out["weights"][:n][order], ref.weights, atol=1e-5, rtol=0)
    assert abs(float(out["wsum"]) - float(ref.weights.sum())) < 1e-3
    gap = ref_dgr.pose_gap(out["transformation"], ref.pose, torch.from_numpy(xyz0))
    assert gap < POSE_TOL_M
    assert int(out["out_of_range"]) == 0 and bool(out["levels_fit"])
    host = reg(xyz0, f0, xyz1, f1)
    assert np.array_equal(host["transformation"], out["transformation"].numpy())
    assert host["weights"].shape == (n,)


TRAFFIC = dict(pool=1, world_points=60000, radius_m=12.0, baseline_m=[10.0, 12.0],
               yaw_deg=10.0, points=12000, noise_m=0.01, image_hw=[8, 8], voxel_size=0.3,
               dim=32, inlier_share=[0.2, 0.6], match_m=0.6, noise=0.1)


@pytest.mark.parametrize("seed", [11, 12, 2147483999])
def test_traffic_plants_its_inlier_share(seed):
    from traffic import dgr as traffic_dgr

    q = traffic_dgr.pair(seed, 0, TRAFFIC)
    assert 0.2 <= q["share"] <= 0.6
    f0, f1 = torch.from_numpy(q["feats0"]), torch.from_numpy(q["feats1"])
    assert torch.allclose(f0.norm(dim=1), torch.ones(len(f0)), atol=1e-5)
    nn = torch.cdist(f0, f1).argmin(dim=1).numpy()
    matched = traffic_dgr.true_matches(q, TRAFFIC["match_m"]) >= 0
    realized = traffic_dgr.realized_share(q, nn, TRAFFIC["match_m"])
    # the planted share of the source voxels that have a true match, and
    # random descriptors that almost never land within match_m by chance
    assert abs(realized - q["share"] * matched.mean()) < 0.05
    again = traffic_dgr.pair(seed, 0, TRAFFIC)
    assert np.array_equal(again["feats1"], q["feats1"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_gap_limit_parts_the_f32_solve_from_the_bf16_control(seed):
    """kitti-dgr-pair's ``pose_gap`` limit lies between the program's f32
    solve and the control's (points and weights rounded to bfloat16), each
    against the reference's f64 SVD, on a KITTI-sized set of correspondences:
    67 000 over 40 m, 30 % inliers under a yaw and 11 m, the rest matched to
    random target points, weights a sigmoid clipped at 0.05."""
    import json

    from imfnet_tpu_torch.match.procrustes import kabsch_umeyama

    limit = json.loads((BENCH / "workloads" / "kitti-dgr-pair.json").read_text())[
        "limits"]["pose_gap"]
    g = torch.Generator().manual_seed(seed)
    n = 67000
    r, a = 40 * torch.rand(n, generator=g).sqrt(), 2 * np.pi * torch.rand(n, generator=g)
    src = torch.stack([r * a.cos(), r * a.sin(), 3 * torch.rand(n, generator=g) - 1.5], 1)
    c, s = np.cos(0.15), np.sin(0.15)
    R = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    dst = src @ R.T + torch.tensor([11.0, 0.5, 0.1])
    outlier = torch.rand(n, generator=g) > 0.3
    dst[outlier] = dst[torch.randint(0, n, (int(outlier.sum()),), generator=g)]
    dst += 0.01 * torch.randn(n, 3, generator=g)
    w = torch.sigmoid(2 * torch.randn(n, generator=g))
    w = torch.where(w >= 0.05, w, torch.zeros_like(w))
    exact = ref_dgr.procrustes(src, dst, w)
    program = ref_dgr.pose_gap(kabsch_umeyama(src, dst, weights=w), exact, src)
    control = ref_dgr.pose_gap(ref_dgr.procrustes(src, dst, w, operands=torch.bfloat16),
                               exact, src)
    assert program * 10 < limit < control / 3, (program, limit, control)
