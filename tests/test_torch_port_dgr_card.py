"""Deep Global Registration's 6-D path on the card (``cuda`` marker; each
test skips without one). The file imports no JAX.

Kernel A's wide-K variant (``"tcw"``: the map block staged in chunks of
offsets) against ``gather_gemm_plain`` at k_vol 729, for each (cin, cout)
of the 6-D network, over a map as sparse as a DGR pyramid's; its walked
and live tally against a count on the host, and its output with the
tally off; the plan at k_vol 729, never scalar for cin ≥ 8; and ``eval.dgr.DGRRegistrar``'s graph replayed against
its eager call bit for bit, with kernel A's 20 wide-K and one cin = 1
launches and one of kernel B a replay.

    python3 -m pytest tests/test_torch_port_dgr_card.py -q -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from imfnet_tpu_torch.sparse.conv_kernel import (conv_plan, gather_gemm, gather_gemm_plain,
                                                 run_plan)
from imfnet_tpu_torch.utils import timer

pytestmark = pytest.mark.cuda
K6 = 3 ** 6
# (cin, cout) of the 6-D network's 20 k3 convs (ResUNetBN2C)
WIDTHS = [(32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
          (256, 128), (256, 64), (128, 64)]
CONV_TOL_REL = 1e-4      # the same exact bf16 products, f32 sums in another order


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel A is built with nvcc and runs only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def sparse_map(gen, n_out, n_in, k, live=0.02):
    """int32[n_out, k]: a live share of the entries name a random input row,
    the centre offset of every row below n_in live; the last tile's rows
    dead (capacity padding)."""
    pick = torch.rand((n_out, k), generator=gen, device="cuda") < live
    rows = torch.randint(0, n_in, (n_out, k), generator=gen, device="cuda")
    nbr = torch.where(pick, rows, torch.full_like(rows, -1))
    nbr[:, k // 2] = torch.arange(n_out, device="cuda") % n_in
    nbr[n_out - 100:] = -1
    return nbr.to(torch.int32).contiguous()


@pytest.mark.parametrize("cin,cout", WIDTHS)
def test_wide_k_matches_plain(gen, cin, cout):
    n_out, n_in = 1500, 1700
    x = torch.randn((n_in, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K6, cin, cout), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    nbr = sparse_map(gen, n_out, n_in, K6)
    plan = conv_plan(n_out, cin, cout, K6, torch.bfloat16)
    assert plan.variant == "tcw"
    before = gather_gemm.launches_tcw
    got = gather_gemm(x, nbr, w)
    assert gather_gemm.launches_tcw == before + 1
    want = gather_gemm_plain(x, nbr, w)
    scale = want.abs().max().clamp_min(1e-6)
    assert float((got - want).abs().max() / scale) < CONV_TOL_REL
    assert torch.equal(got[n_out - 100:], torch.zeros_like(got[n_out - 100:]))
    assert torch.equal(got, gather_gemm(x, nbr, w))          # bit-equal across calls
    for split in (2, 8):                                     # the cluster split
        again = run_plan(x, nbr, w, plan._replace(split=split))
        assert float((again - want).abs().max() / scale) < CONV_TOL_REL


def test_plan_at_729_is_never_scalar(gen):
    for n_out in (1, 900, 65536, 131072):
        for cin in (8, 16, 32, 64, 128, 256, 512):
            for cout in (8, 32, 64, 128, 256):
                plan = conv_plan(n_out, cin, cout, K6, torch.bfloat16)
                assert plan.variant == "tcw", (n_out, cin, cout, plan)
    assert conv_plan(131072, 1, 32, K6, torch.bfloat16).variant == "cin1"


def test_walk_tally_matches_a_host_count(gen):
    n_out, n_in, cin, cout = 1000, 900, 32, 64
    x = torch.randn((n_in, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((K6, cin, cout), generator=gen, device="cuda").to(torch.bfloat16)
    nbr = sparse_map(gen, n_out, n_in, K6, live=0.005)
    live = nbr >= 0
    tiles = -(-n_out // 128)
    pad = torch.zeros((tiles * 128 - n_out, K6), dtype=torch.bool, device="cuda")
    per_tile = torch.cat([live, pad]).view(tiles, 128, K6).any(dim=1).sum()
    timer.reset()
    with timer.tracing():
        gather_gemm(x, nbr, w)
        rec = timer.record()
    assert rec["counters"]["conv.slots_walked"] == int(per_tile) * 128
    assert rec["counters"]["conv.entries_live"] == int(live.sum())
    assert rec["counters"]["conv.map_slots"] == n_out * K6
    timer.reset()


def test_walk_tally_off_leaves_the_output(gen):
    n_out, n_in, cin, cout = 700, 800, 64, 64
    x = torch.randn((n_in, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((K6, cin, cout), generator=gen, device="cuda").to(torch.bfloat16)
    nbr = sparse_map(gen, n_out, n_in, K6)
    plan = conv_plan(n_out, cin, cout, K6, torch.bfloat16)
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
