"""Kernel A's host side, without a card: the plan that picks its variant,
tile and split (``sparse/conv_kernel.py::conv_plan``), the wrapper's CPU
path, and the build's library naming (``utils/cuda_build.py``)."""
import shutil

import pytest
import torch

from chip_smoke import MAIN_PATH_CONVS
from imfnet_tpu_torch.sparse.conv_kernel import (CIN1_BMS, CIN1_BN, MAX_SPLIT, MAX_STEPS,
                                                 SMEM_LIMIT, TARGET_BLOCKS, TC_TILES, TCW_BK,
                                                 TCW_BM, TCW_BNS, TCW_L2_BYTES, WIDE_MACS, ConvPlan,
                                                 cin1_smem_bytes,
                                                 conv_plan, gather_gemm, gather_gemm_plain,
                                                 run_plan, tc_smem_bytes, tcw_smem_bytes)
from imfnet_tpu_torch.train.step import level_capacities
from imfnet_tpu_torch.utils import cuda_build

H100_SMS = 132
# the bench cell's level capacities: 2-batch pad 65 536, divisors (1, 3, 8, 20)
CAPS = level_capacities(65536, (1, 3, 8, 20))
# each distinct conv of the main path (the first name of its shape):
# (name, n_out, cin, cout)
_FIRST = {}
for _name, _level, _map, _cin, _cout in MAIN_PATH_CONVS:
    _FIRST.setdefault((_level, _map, _cin, _cout), (_name, CAPS[_level], _cin, _cout))
SHAPES = list(_FIRST.values())
COARSE = [s for s in SHAPES if s[1] <= CAPS[2]]


def test_bench_shapes():
    assert tuple(CAPS) == (65536, 21845, 8192, 3276)
    assert len(SHAPES) == 11 and len(COARSE) == 5


@pytest.mark.parametrize("name,n_out,cin,cout", SHAPES, ids=[s[0] for s in SHAPES])
def test_main_path_shapes_take_tensor_cores(name, n_out, cin, cout):
    plan = conv_plan(n_out, cin, cout, 27, torch.bfloat16)
    assert plan.variant == "tc"
    assert (plan.bm, plan.bn, plan.bk) in TC_TILES
    assert plan.bn >= min(cout, 128)             # no column tile wider than needed
    assert plan.bk == (64 if plan.bn == 128 and cin * cout >= WIDE_MACS else 32)
    assert tc_smem_bytes(plan.bn, plan.bk, 27) <= SMEM_LIMIT
    assert plan.split in (1, 2, 4, 8) and plan.bm % plan.split == 0


@pytest.mark.parametrize("name,n_out,cin,cout", COARSE, ids=[s[0] for s in COARSE])
def test_coarse_shapes_get_enough_blocks(name, n_out, cin, cout):
    """At the L2 and L3 capacities the offsets are split until the grid has
    TARGET_BLOCKS blocks: at least one per SM, whatever share is live."""
    plan = conv_plan(n_out, cin, cout, 27, torch.bfloat16)
    assert plan.split > 1
    assert plan.blocks(n_out, cout) >= TARGET_BLOCKS >= H100_SMS


@pytest.mark.parametrize("dtype,cin,cout,aligned", [
    (torch.float32, 32, 32, True),      # f32 keeps its 1e-4 parity: no TF32
    (torch.float32, 256, 256, True),
    (torch.bfloat16, 20, 32, True),     # cin % 8 != 0
    (torch.bfloat16, 32, 20, True),     # cout % 8 != 0
    (torch.bfloat16, 32, 32, False),    # x or w not 16-byte aligned
])
def test_scalar_variant(dtype, cin, cout, aligned):
    plan = conv_plan(65536, cin, cout, 27, dtype, aligned)
    assert plan == ConvPlan("scalar", 64, 64, 32, 1)


# (dtype, k_vol, aligned) of a one-channel conv; the first is the case
# test_scalar_variant held until the cin = 1 variant took it over
CIN1_CASES = [(torch.bfloat16, 27, True)] + [
    (dtype, k_vol, aligned) for dtype in (torch.bfloat16, torch.float32)
    for k_vol in (27, 125, 343) for aligned in (True, False)
    if (dtype, k_vol, aligned) != (torch.bfloat16, 27, True)]


@pytest.mark.parametrize("dtype,k_vol,aligned", CIN1_CASES)
@pytest.mark.parametrize("cout", [32, 64])
def test_cin1_variant(dtype, k_vol, aligned, cout):
    """One input channel takes the cin = 1 variant in both dtypes, at any
    alignment and kernel volume: the most rows a block whose shared memory
    fits (k5's 125 offsets: 128 rows; k7's 343: 64), 32 channels a pass."""
    plan = conv_plan(65536, 1, cout, k_vol, dtype, aligned)
    assert plan.variant == "cin1"
    assert plan.bm in CIN1_BMS and (plan.bn, plan.bk, plan.split) == (CIN1_BN, 1, 1)
    assert cin1_smem_bytes(plan.bm, k_vol) <= SMEM_LIMIT
    assert plan.bm == max(bm for bm in CIN1_BMS if cin1_smem_bytes(bm, k_vol) <= SMEM_LIMIT)
    assert plan.bm == (64 if k_vol == 343 else 128)
    assert plan.blocks(65536, CIN1_BN) == 65536 // plan.bm


# (k_vol, cin, cout) -> the tile (bn, bk) that fits, or None where none
# does and the wide-K walk takes the call
WIDE_K = [(125, 256, 256, (128, 64)), (125, 32, 32, (32, 32)),
          (172, 256, 256, (128, 64)), (173, 256, 256, (128, 32)),
          (343, 256, 256, (32, 32)), (343, 64, 64, (32, 32)),
          (351, 128, 128, (32, 32)), (352, 32, 32, None), (1000, 256, 256, None)]


@pytest.mark.parametrize("k_vol,cin,cout,tile", WIDE_K)
def test_plan_fits_shared_memory(k_vol, cin, cout, tile):
    """The map block grows with k_vol: the step, then the tile narrow until
    the block fits the H100's shared memory, else the wide-K walk (lists of
    live entries per offset, chunks of TCW_BM entries) with the least
    output-channel tile that holds cout."""
    plan = conv_plan(4096, cin, cout, k_vol, torch.bfloat16)
    if tile is None:
        bn = next(b for b in TCW_BNS if cout <= b)
        assert plan[:4] == ("tcw", TCW_BM, bn, TCW_BK)
        # offsets a pass: the fewest equal passes whose W slices fit L2
        slice_bytes, passes = cin * cout * 2, -(-k_vol // plan.split)
        assert plan.split * slice_bytes <= TCW_L2_BYTES
        if passes > 1:
            assert -(-k_vol // (passes - 1)) * slice_bytes > TCW_L2_BYTES
        assert tc_smem_bytes(32, 32, k_vol) > SMEM_LIMIT
        assert tcw_smem_bytes(plan.bn) <= SMEM_LIMIT
        return
    assert plan.variant == "tc" and (plan.bn, plan.bk) == tile
    assert (plan.bm, plan.bn, plan.bk) in TC_TILES
    assert tc_smem_bytes(plan.bn, plan.bk, k_vol) <= SMEM_LIMIT


def test_only_reachable_instances_are_built():
    """Every tensor-core instance is some plan's choice: a 64-channel step
    only on a 128-wide tile."""
    chosen = {(p.bm, p.bn, p.bk) for cin in (8, 32, 64, 128, 256, 1024)
              for cout in (8, 32, 64, 128, 256) for k in (27, 125, 343)
              for p in [conv_plan(8192, cin, cout, k, torch.bfloat16)]}
    assert chosen == set(TC_TILES)


def test_run_plan_needs_cuda_tensors():
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    w = torch.zeros((27, 32, 32), dtype=torch.bfloat16)
    nbr = torch.full((4, 27), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_plan(x, nbr, w, conv_plan(4, 32, 32, 27, torch.bfloat16))


@pytest.mark.parametrize("n_out", [1, 900, 65536])
@pytest.mark.parametrize("k_vol", [1, 8, 27, 125])
def test_split_stays_within_its_bounds(n_out, k_vol):
    for cin, cout in [(32, 32), (256, 64), (256, 256)]:
        plan = conv_plan(n_out, cin, cout, k_vol, torch.bfloat16)
        s = plan.split
        assert s & (s - 1) == 0 and s <= min(MAX_SPLIT, k_vol)
        steps = k_vol * -(-cin // plan.bk)
        at_limit = 2 * s > min(MAX_SPLIT, k_vol)
        assert at_limit or (plan.blocks(n_out, cout) >= TARGET_BLOCKS
                            and steps <= MAX_STEPS * s)
        if s > 1:   # the smallest split that meets both
            half = plan._replace(split=s // 2)
            assert (half.blocks(n_out, cout) < TARGET_BLOCKS
                    or steps > MAX_STEPS * half.split)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_gemm_on_cpu_runs_the_plain_version(dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((50, 32), generator=gen).to(dtype)
    w = torch.randn((27, 32, 16), generator=gen).to(dtype)
    nbr = torch.randint(-1, 50, (60, 27), generator=gen, dtype=torch.int32)
    counts = lambda: (gather_gemm.launches, gather_gemm.launches_tc,  # noqa: E731
                      gather_gemm.launches_cin1, gather_gemm.launches_scalar)
    before = counts()
    out = gather_gemm(x, nbr, w)
    assert torch.equal(out, gather_gemm_plain(x, nbr, w))
    assert counts() == before


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header names a new library, so a stale build
    is never loaded; so does an edit to the source itself."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "sparse_conv.cu includes a header of csrc/"
    first = cuda_build.library_path("sparse_conv")
    assert cuda_build.library_path("sparse_conv") == first
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    second = cuda_build.library_path("sparse_conv")
    assert second != first and second.parent == cuda_build.BUILD_DIR
    (csrc / "sparse_conv.cu").write_bytes((csrc / "sparse_conv.cu").read_bytes() + b" ")
    assert cuda_build.library_path("sparse_conv") not in (first, second)
