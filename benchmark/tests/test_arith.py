"""The yardstick's arithmetic against hand counts at small shapes."""
import pytest
import torch

from benchlib import arith, trace
from benchlib.harness import percentile


def test_kernel_a_bytes_and_operations_by_hand():
    # 3 outputs, 2 offsets; rows 0 and 2 named, offset 1 never live
    nbr = torch.tensor([[0, -1], [2, -1], [-1, -1]])
    c = arith.conv_stats("c", nbr, n_in=4, cin=8, cout=16, path="A")
    assert (c["live"], c["rows"], c["offsets"]) == (2, 2, 1)
    # x rows 2*8*2, map 3*2*4, W 1 offset 8*16*2, output 3*16*4
    assert arith.kernel_a_bytes(c) == 32 + 24 + 256 + 192
    assert arith.conv_flops(c) == 2 * 2 * 8 * 16


def test_kernel_b_bytes_and_operations_by_hand():
    assert arith.nn_bytes(10, 20, 32) == 30 * 32 * 4 + 10 * 8
    assert arith.nn_flops(10, 20, 32) == 2 * 10 * 20 * 32


def test_resnet_operations_by_hand():
    # stem alone: 8x8 image -> 4x4 output of 64 channels, 7x7x3 taps
    stem = 2 * 4 * 4 * 3 * 64 * 49
    # one stage of one block at 2x2 after the pool, 64 -> 64 twice
    block = 2 * (2 * 2 * 2 * 64 * 64 * 9)
    assert arith.resnet_flops(1, 8, 8, stages=(1,), widths=(64,)) == stem + block


def test_fusion_operations_by_hand():
    m, t, lat, dim = 3, 5, 8, 4
    inner, ff = 4, 32
    want = 2 * (m * lat * inner + t * dim * 2 * inner + 2 * m * t * inner
                + m * inner * lat + m * lat * 2 * ff + m * ff * lat)
    assert arith.fusion_flops(m, t, lat, dim) == want


def test_union_counts_overlapping_time_once():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    assert trace.union_ns([(0, 10), (0, 10)]) == 10
    assert trace.union_ns([]) == 0


def test_gaps_and_clipping_to_the_window():
    ops = [trace.DeviceOp("a", -5, 10, "kernel"), trace.DeviceOp("b", 5, 15, "kernel"),
           trace.DeviceOp("c", 20, 40, "memcpy")]
    win = (0, 30)
    iv = trace.clip(ops, win)
    assert iv == [(0, 10), (5, 15), (20, 30)]
    assert trace.gaps(iv, win) == [(15, 20)]
    tr = trace.Trace(ops, [("bench.result", 12, 25)], win, 1)
    assert arith.busy_s(tr) == pytest.approx(25e-9)
    assert trace.breakdown(tr)["idle_gaps"] == [["bench.result", 5e-9]]


def test_roofline_share_reads_nothing_without_launches():
    assert arith.roofline_share([], 1.0) is None
    assert arith.roofline_share([1e-3], 0.0) is None
    assert arith.roofline_share([1e-3, 1e-3], 4e-3) == pytest.approx(50.0)


def test_nearest_rank_percentile():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([3.0], 95) == 3.0
