"""The two kernel paths redesigned for the card and the loader's staging
ring: kernel A's cin = 1 variant, kernel B's min fold at D = 3, and
``train/trainer.py::BatchStager``.

On the CPU: a model of each kernel's arithmetic, the order the kernel
takes it in emulated in PyTorch (A's offset-ordered sum; B's running
minimum per tile and the re-walk of the tile that last lowered it), held to
the JAX package (A's conv1 against ``imfnet_tpu.sparse.ops._z3_apply``, the
JAX path of every cin = 1 conv; B against the TPU kernel ``nn_pallas`` in
interpret mode) and to the port's plain versions; the staging slab's
layout, packed and unpacked field for field. On the card (``cuda`` marker;
skipped without one): the launched kernels against the same JAX functions
on the same inputs and against their plain versions, and batches through
the ring against ``t.to("cuda")``:

    python -m pytest tests/test_torch_port_slice12.py -q
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.match.pallas_nn import nn_pallas
from imfnet_tpu.sparse.ops import _z3_apply

from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.match.nn_kernel import (NN_MIN_GEOMETRY, NN_MIN_TILES, NNPlan, flash_nn,
                                                nn_plain, nn_plan, run_plan as nn_run_plan)
from imfnet_tpu_torch.sparse.conv_kernel import (conv_plan, gather_gemm, gather_gemm_plain,
                                                 run_plan)
from imfnet_tpu_torch.sparse.grid import GridSpec, quantize_grid
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid
from imfnet_tpu_torch.train.step import PairBatch
from imfnet_tpu_torch.train.trainer import (STAGING_ALIGN, STAGING_SLOTS, BatchStager,
                                            batch_to_device, pack_fields, staging_layout,
                                            unpack_fields)

VOXEL = 0.025
CAP = 1024


@pytest.fixture(scope="module")
def k5_map():
    """The k5 conv1 map (125 offsets) of a small two-fragment level 0, in
    scan order, as the training step builds it."""
    rng = np.random.RandomState(0)
    n = 3000
    t = rng.rand(n, 2) * 0.3
    xyz = np.stack([t[:, 0], t[:, 1], 0.1 * np.sin(6 * t[:, 0]) + rng.randn(n) * 0.01],
                   axis=1).astype(np.float32)
    batch = (np.arange(n) >= n // 2).astype(np.int32)
    sv, _, _ = quantize_grid(torch.from_numpy(xyz), torch.ones((n, 1)),
                             torch.ones((n,), dtype=torch.bool), VOXEL, CAP,
                             GridSpec(extent=(64, 64, 64), num_batches=2),
                             batch_index=torch.from_numpy(batch))
    pyr = build_pyramid(sv.coords, sv.num_valid, level_capacity=(CAP, 512, 256, 128))
    nbr = pyr.k5_l0
    assert nbr.shape == (CAP, 125) and 0 < int(sv.num_valid) < CAP
    return nbr


def cin1_emulation(x, nbr, w):
    """What the cin = 1 variant computes, in its order: per output row
    the f32 sum over offsets k = 0 .. k_vol-1 of x[nbr[i, k]] · W[k, 0, :],
    each step one fused multiply-add (an f64 product, exact for f32 and
    bf16 operands, rounded to f32 with the sum), a -1 entry contributing 0."""
    n_in = x.shape[0]
    xd = torch.cat([x.double()[:, 0], x.new_zeros(1).double()])
    idx = torch.where(nbr >= 0, nbr, n_in).long()
    acc = torch.zeros((nbr.shape[0], w.shape[2]), dtype=torch.float32)
    for k in range(nbr.shape[1]):
        acc = (acc.double() + xd[idx[:, k], None] * w[k, 0].double()[None, :]).float()
    return acc


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cout", [32, 64])
def test_cin1_order_matches_jax_conv1(k5_map, dtype, cout):
    """The variant's summation order against the JAX package's cin = 1 path
    (``_z3_apply``, the z-window gather and one product, f32 accumulation)
    and the port's plain version: the same exact products summed in
    another order, 1e-5 of the output's scale; dead rows exact 0."""
    rng = np.random.RandomState(cout)
    n_in = k5_map.shape[0]
    x = torch.from_numpy(rng.randn(n_in, 1).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(125, 1, cout) / 125 ** 0.5).astype(np.float32)).to(dtype)
    got = cin1_emulation(x, k5_map, w)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(_z3_apply(jnp.asarray(x.float().numpy()).astype(jdt),
                               jnp.asarray(k5_map.numpy()),
                               jnp.asarray(w.float().numpy()).astype(jdt), kz=5))
    plain = gather_gemm_plain(x, k5_map, w)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5 * scale)
    dead = (k5_map < 0).all(dim=1)
    assert dead.any() and bool((got[dead] == 0).all())
    # the wrapper on the CPU runs the plain version; the card takes cin1
    assert torch.equal(gather_gemm(x, k5_map, w), plain)
    assert conv_plan(n_in, 1, cout, 125, dtype).variant == "cin1"


def min_fold_emulation(q, r, valid, plan):
    """What the min fold computes, as the kernel walks it: d = |r|² +
    Σ_c (−2 q_c) r_c by three fused multiply-adds from the norm (+inf for an
    invalid reference); per part of the split and per thread column, the
    running minimum over its tiles, the last tile that lowered it
    (strictly), and the first reference of that tile at the minimum; then
    the columns and the parts merged by (d, lowest index); d² = max(d +
    |q|², 0) and (0, +inf) where nothing is valid."""
    n, m = q.shape[0], r.shape[0]
    _, tr, _, gx = NN_MIN_GEOMETRY[(plan.bq, plan.br, plan.threads)]
    r_sq = torch.zeros(m)
    for c in range(3):
        r_sq = (r_sq.double() + r[:, c].double() ** 2).float()
    q_sq = torch.zeros(n)
    for c in range(3):
        q_sq = (q_sq.double() + q[:, c].double() ** 2).float()
    rr = torch.where(valid, r_sq, torch.full_like(r_sq, float("inf")))
    d = rr[None, :].expand(n, m).clone()
    for c in range(3):
        d = (d.double() + (-2.0 * q[:, c]).double()[:, None] * r[:, c].double()[None, :]).float()
    best_d = torch.full((n,), float("inf"))
    best_i = torch.zeros((n,), dtype=torch.int64)
    for start, stop in plan.part_ranges(m):
        for tx in range(gx):
            run = torch.full((n,), float("inf"))
            tile_of = torch.full((n,), -1, dtype=torch.int64)
            cols = []
            for t0 in range(start, stop, plan.br):
                idx = torch.tensor([t0 + tx * 4 + (j // 4) * gx * 4 + j % 4 for j in range(tr)])
                idx = idx[idx < m]
                cols.append(idx)
                if idx.numel():
                    mn = torch.minimum(run, d[:, idx].min(dim=1).values)
                    tile_of = torch.where(mn < run, len(cols) - 1, tile_of)
                    run = mn
            bi = torch.zeros((n,), dtype=torch.int64)
            for i in range(n):
                if tile_of[i] >= 0:
                    idx = cols[tile_of[i]]
                    bi[i] = idx[int(torch.nonzero(d[i, idx] == run[i])[0])]
            nearer = (run < best_d) | ((run == best_d) & (bi < best_i))
            best_d = torch.where(nearer, run, best_d)
            best_i = torch.where(nearer, bi, best_i)
    return best_i.to(torch.int32), torch.clamp_min(best_d + q_sq, 0.0)


def _points(seed, n, m):
    rng = np.random.RandomState(seed)
    q = (rng.rand(n, 3) * 2.0 - 1.0).astype(np.float32)
    r = (rng.rand(m, 3) * 2.0 - 1.0).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(rng.rand(m) > 0.2)


@pytest.mark.parametrize("tile", sorted(NN_MIN_TILES))
@pytest.mark.parametrize("case", ["random", "lattice ties", "all invalid"])
def test_min_fold_emulation_matches_plain(tile, case):
    """The min fold, emulated in each built tile, gives the plain version's
    choices: equal indices where no two references are near-tied, and on a
    lattice with exact ties (every reference twice, on a 2.5 cm grid) the
    lowest index at the least exact distance; d² within 1e-6; (0, +inf)
    with no valid reference."""
    n, m = 150, 700
    q, r, valid = _points(1, n, m)
    if case == "lattice ties":
        q = torch.round(q / VOXEL) * VOXEL
        r = torch.round(r / VOXEL) * VOXEL
        r[m // 2:] = r[:m // 2]
        valid = torch.ones(m, dtype=torch.bool)
    elif case == "all invalid":
        valid = torch.zeros(m, dtype=torch.bool)
    plan = NNPlan(*tile, split=3, fold="min")
    idx, d2 = min_fold_emulation(q, r, valid, plan)
    ref_i, ref_d = nn_plain(q, r, valid)
    if case == "all invalid":
        assert (idx == 0).all() and torch.isinf(d2).all()
        return
    exact = ((q.double()[:, None, :] - r.double()[None]) ** 2).sum(-1)
    exact = exact.masked_fill(~valid[None], float("inf"))
    got, want = exact[torch.arange(n), idx.long()], exact.min(dim=1).values
    assert float((got - want).max()) <= 1e-6
    torch.testing.assert_close(d2, ref_d, rtol=0, atol=1e-6)
    if case == "random":
        assert torch.equal(idx, ref_i)
    else:
        # of the references at the chosen distance, the lowest index
        assert bool((idx < m // 2).all())
        assert torch.equal(idx, torch.where(exact <= got[:, None], torch.arange(m), m)
                           .min(dim=1).values.to(torch.int32))


@pytest.mark.parametrize("n,m", [(300, 700), (129, 5003), (31, 129)])
def test_min_fold_emulation_matches_pallas_kernel(n, m):
    """The D = 3 plan, emulated, against the TPU kernel in interpret mode:
    indices equal, d² within 1e-5."""
    q, r, valid = _points(2, n, m)
    plan = nn_plan(n, m, 3)
    assert plan.fold == "min"
    ref_i, ref_d = nn_pallas(jnp.asarray(q.numpy()), jnp.asarray(r.numpy()),
                             jnp.asarray(valid.numpy()), tq=128, tr=256, interpret=True)
    idx, d2 = min_fold_emulation(q, r, valid, plan)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d), rtol=0, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors and counts no launch
    before = flash_nn.launches
    got_i, _ = flash_nn(q, r, valid)
    assert flash_nn.launches == before
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def _host_batch(seed, n_pad=2048):
    return synthetic_batch(np.random.RandomState(seed), batch_size=2, n_points=900,
                           n_pad=n_pad, image_hw=(8, 12), device="cpu")


def test_staging_layout_round_trips_field_for_field():
    """Every host field packs at a STAGING_ALIGN boundary of one slab and
    unpacks as a view equal to it (dtype, shape, values); None stays None."""
    batch = _host_batch(0)._replace(search_radius=None)
    fields, offsets, total = staging_layout(batch)
    assert [i for i, _, _ in fields] == [i for i, t in enumerate(batch) if t is not None]
    assert all(off % STAGING_ALIGN == 0 for off in offsets) and total % STAGING_ALIGN == 0
    ends = [off + nbytes for (_, _, nbytes), off in zip(fields, offsets)]
    assert all(e <= nxt for e, nxt in zip(ends, offsets[1:])) and ends[-1] <= total
    slab = torch.zeros((total,), dtype=torch.uint8)
    pack_fields(slab, fields, offsets)
    out = unpack_fields(batch, slab, fields, offsets)
    assert isinstance(out, PairBatch) and out.search_radius is None
    for a, b in zip(batch, out):
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        assert (b.data_ptr() - slab.data_ptr()) % STAGING_ALIGN == 0 and b.is_contiguous()


def test_staging_takes_empty_and_scalar_fields():
    batch = _host_batch(1)
    batch = batch._replace(pairs=torch.zeros((0, 2), dtype=torch.int64),
                           pair_valid=torch.zeros((0,), dtype=torch.bool))
    fields, offsets, total = staging_layout(batch)
    slab = torch.zeros((total,), dtype=torch.uint8)
    pack_fields(slab, fields, offsets)
    out = unpack_fields(batch, slab, fields, offsets)
    assert out.pairs.shape == batch.pairs.shape and out.n0.shape == ()
    assert int(out.n0) == int(batch.n0) and torch.equal(out.T_gt, batch.T_gt)


def test_staging_stays_off_the_cpu_path():
    """On the CPU a batch moves by ``t.to(device)``; a stager is for a card."""
    batch = _host_batch(2)
    out = batch_to_device(batch, torch.device("cpu"))
    assert all(a is b or torch.equal(a, b) for a, b in zip(batch, out) if a is not None)
    with pytest.raises(ValueError, match="CUDA device"):
        BatchStager(torch.device("cpu"))


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc and run only "
                    "on the card")
    return torch.Generator(device="cuda").manual_seed(12)


def _cin1_map(gen, n_in, n_out, k_vol):
    nbr = torch.randint(0, n_in, (n_out, k_vol), generator=gen, device="cuda")
    drop = torch.rand((n_out, k_vol), generator=gen, device="cuda") < 0.7
    nbr = torch.where(drop, -1, nbr).to(torch.int32)
    nbr[3] = -1                     # a row of all -1
    nbr[n_out - 200:] = -1          # whole dead tiles at the end
    return nbr.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [129, 1000, 4133])
@pytest.mark.parametrize("k_vol", [27, 125, 343])
@pytest.mark.parametrize("cout", [32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cin1_kernel_matches_plain(gen, n_out, k_vol, cout, dtype):
    """Ragged row counts, all-dead tiles, rows of all -1: within 1e-4 of the
    output's scale of the plain version, dead rows exact 0, two calls
    bit-equal, one cin1 launch a call and no scalar one."""
    x = torch.randn((900, 1), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k_vol, 1, cout), generator=gen, device="cuda") * 0.1).to(dtype)
    nbr = _cin1_map(gen, 900, n_out, k_vol)
    before = (gather_gemm.launches_cin1, gather_gemm.launches_scalar)
    out, again = gather_gemm(x, nbr, w), gather_gemm(x, nbr, w)
    ref = gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    assert (gather_gemm.launches_cin1, gather_gemm.launches_scalar) == (before[0] + 2,
                                                                        before[1])
    dead = (nbr < 0).all(dim=1)
    assert dead[3] and bool((out[dead] == 0).all())
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * max(1.0, ref.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [32, 64, 128])
def test_cin1_kernel_every_block_size(gen, bm):
    """Each block size the kernel takes, at a misaligned map (its rows start
    4 bytes off a 16-byte line, so the staging falls back to 4-byte loads)."""
    x = torch.randn((700, 1), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((125, 1, 32), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    full = _cin1_map(gen, 700, 1001, 125)
    nbr = full.view(-1)[125:].view(1000, 125)
    assert nbr.data_ptr() % 16 != 0
    plan = conv_plan(1000, 1, 32, 125, torch.bfloat16)._replace(bm=bm)
    out = run_plan(x, nbr, w, plan)
    ref = gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * max(1.0, ref.abs().max().item()))


def _lattice(gen, n, step=VOXEL):
    return torch.round(torch.rand((n, 3), generator=gen, device="cuda") * 40) * step


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 129), (127, 128), (129, 255), (4999, 5003),
                                 (20000, 20000)])
@pytest.mark.parametrize("case", ["lattice ties", "all invalid", "gaussian masked"])
def test_min_fold_matches_plain(gen, n, m, case):
    """Kernel B's D = 3 plan (the min fold) against the plain version on
    lattice points whose references all come twice (exact ties), with no
    valid reference, and on Gaussian points, at ragged sizes around the tile
    edges: every choice valid and at the least exact distance (within twice
    the d² tolerance, 2e-6 of the largest squared norm), of two equal
    references the first, d² within the tolerance of the plain version's,
    two calls bit-equal."""
    q = _lattice(gen, n)
    half = _lattice(gen, m // 2)
    r = torch.cat([half, half])
    valid = torch.rand((m // 2,), generator=gen, device="cuda") > 0.2
    valid = torch.cat([valid, valid])
    if case == "all invalid":
        valid[:] = False
    elif case == "gaussian masked":
        q = torch.randn((n, 3), generator=gen, device="cuda")
        r = torch.randn((m, 3), generator=gen, device="cuda")
        valid = torch.rand((m,), generator=gen, device="cuda") > 0.2
    plan = nn_plan(n, r.shape[0], 3)
    assert plan.fold == "min"
    i_k, d_k = nn_run_plan(q, r, valid, plan)
    i_2, d_2 = nn_run_plan(q, r, valid, plan)
    i_p, d_p = nn_plain(q, r, valid)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_2) and torch.equal(d_k, d_2)
    if case == "all invalid":
        assert (i_k == 0).all() and torch.isinf(d_k).all()
        return
    tol = 2e-6 * max(1.0, float((q * q).sum(1).max()), float((r * r).sum(1).max()))
    exact = ((q.double()[:, None, :] - r.double()[None]) ** 2).sum(-1) if n * m <= 1e7 else \
        torch.cdist(q.double(), r.double()) ** 2
    exact = exact.masked_fill(~valid[None], float("inf"))
    got = exact[torch.arange(n, device="cuda"), i_k.long()]
    assert bool(valid[i_k.long()].all())
    assert float((got - exact.min(dim=1).values).max()) <= 2 * tol
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=tol)
    if case == "lattice ties":
        assert bool((i_k < m // 2).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cout", [32, 64])
def test_cin1_kernel_matches_jax_conv1(gen, k5_map, dtype, cout):
    """The launched cin1 variant against the JAX package's cin = 1 path
    (``_z3_apply``) on the inputs of ``test_cin1_order_matches_jax_conv1``:
    within 1e-5 of the output's scale, dead rows exactly 0, one cin1
    launch."""
    rng = np.random.RandomState(cout)
    n_in = k5_map.shape[0]
    x = torch.from_numpy(rng.randn(n_in, 1).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(125, 1, cout) / 125 ** 0.5).astype(np.float32)).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(_z3_apply(jnp.asarray(x.float().numpy()).astype(jdt),
                               jnp.asarray(k5_map.numpy()),
                               jnp.asarray(w.float().numpy()).astype(jdt), kz=5))
    nbr = k5_map.cuda()
    before = (gather_gemm.launches_cin1, gather_gemm.launches_scalar)
    out = gather_gemm(x.cuda(), nbr, w.cuda())
    torch.cuda.synchronize()
    assert (gather_gemm.launches_cin1, gather_gemm.launches_scalar) == (before[0] + 1,
                                                                        before[1])
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=0, atol=1e-5 * scale)
    dead = (nbr < 0).all(dim=1)
    assert dead.any() and bool((out[dead] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(300, 700), (129, 5003), (31, 129)])
def test_min_fold_kernel_matches_pallas_kernel(gen, n, m):
    """The launched D = 3 plan (the min fold) against the TPU kernel in
    interpret mode on the inputs of
    ``test_min_fold_emulation_matches_pallas_kernel``: indices equal, d²
    within 1e-5, one launch."""
    q, r, valid = _points(2, n, m)
    ref_i, ref_d = nn_pallas(jnp.asarray(q.numpy()), jnp.asarray(r.numpy()),
                             jnp.asarray(valid.numpy()), tq=128, tr=256, interpret=True)
    assert nn_plan(n, m, 3).fold == "min"
    before = flash_nn.launches
    idx, d2 = flash_nn(q.cuda(), r.cuda(), valid.cuda())
    torch.cuda.synchronize()
    assert flash_nn.launches == before + 1
    np.testing.assert_array_equal(idx.cpu().numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d2.cpu().numpy(), np.asarray(ref_d), rtol=0, atol=1e-5)


def _assert_moved(h, d):
    for a, b in zip(h, d):
        if a is None:
            assert b is None
            continue
        assert b.device.type == "cuda" and b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(b.cpu(), a) and torch.equal(b, a.to("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("consumer", ["in step", "behind the whole ring"])
def test_staging_ring_equals_to_cuda(gen, consumer):
    """A sequence of batches through the card's ring (``batch_to_device``)
    equals ``t.to("cuda")`` field for field, read as each arrives or only
    after all nine were moved (the consumer behind by the whole ring and
    more), including batches larger than the slots they meet."""
    assert STAGING_SLOTS < 9
    hosts = [_host_batch(s, n_pad=4096 if s % 3 == 2 else 2048) for s in range(9)]
    moved = []
    for h in hosts:
        moved.append(batch_to_device(h, torch.device("cuda")))
        if consumer == "in step":
            torch.cuda.synchronize()
            _assert_moved(h, moved[-1])
    torch.cuda.synchronize()
    for h, d in zip(hosts, moved):
        _assert_moved(h, d)
