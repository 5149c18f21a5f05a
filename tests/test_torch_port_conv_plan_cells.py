"""Kernel A's plan at every conv shape of the benchmark's four cells
(3dmatch-pair, kitti-pair, 3dmatch-train, 3dmatch-extract), held to the
plans the 3-D path ran before the wide-K variant existed, as a literal
table: the plan rule now also covers k_vol 729, and no 3-D conv may
change its launch."""
import pytest
import torch

from chip_smoke import MAIN_PATH_CONVS
from imfnet_tpu_torch.sparse.conv_kernel import ConvPlan, conv_plan
from imfnet_tpu_torch.train.step import level_capacities

# n_out cin cout k_vol  variant bm bn bk split
PLANS = """
       409 128 256  27  tc   128 128 64 8
       409 256 256  27  tc   128 128 64 8
       614 128 256  27  tc   128 128 64 8
       614 256 256  27  tc   128 128 64 8
       819 128 256  27  tc   128 128 64 8
       819 256 256  27  tc   128 128 64 8
      1024  64 128  27  tc   128 128 32 8
      1024 128 128  27  tc   128 128 32 8
      1024 128 256  27  tc   128 128 64 8
      1024 256 128  27  tc   128 128 64 8
      1024 256 256  27  tc   128 128 64 8
      1228 128 256  27  tc   128 128 64 8
      1228 256 256  27  tc   128 128 64 8
      1433 128 256  27  tc   128 128 64 8
      1433 256 256  27  tc   128 128 64 8
      1536  64 128  27  tc   128 128 32 8
      1536 128 128  27  tc   128 128 32 8
      1536 256 128  27  tc   128 128 64 8
      1638 128 256  27  tc   128 128 64 8
      1638 256 256  27  tc   128 128 64 8
      2048  64 128  27  tc   128 128 32 8
      2048 128 128  27  tc   128 128 32 8
      2048 128 256  27  tc   128 128 64 8
      2048 256 128  27  tc   128 128 64 8
      2048 256 256  27  tc   128 128 64 8
      2457 128 256  27  tc   128 128 64 8
      2457 256 256  27  tc   128 128 64 8
      2560  64 128  27  tc   128 128 32 8
      2560 128 128  27  tc   128 128 32 8
      2560 256 128  27  tc   128 128 64 8
      2730  32  64  27  tc   128  64 32 8
      2730  64  64  27  tc   128  64 32 8
      2730 256  64  27  tc   128  64 32 8
      2867 128 256  27  tc   128 128 64 8
      2867 256 256  27  tc   128 128 64 8
      3072  64 128  27  tc   128 128 32 8
      3072 128 128  27  tc   128 128 32 8
      3072 256 128  27  tc   128 128 64 8
      3276 128 256  27  tc   128 128 64 8
      3276 256 256  27  tc   128 128 64 8
      3584  64 128  27  tc   128 128 32 8
      3584 128 128  27  tc   128 128 32 8
      3584 256 128  27  tc   128 128 64 8
      4096  32  64  27  tc   128  64 32 8
      4096  64  64  27  tc   128  64 32 8
      4096  64 128  27  tc   128 128 32 8
      4096 128 128  27  tc   128 128 32 8
      4096 256  64  27  tc   128  64 32 8
      4096 256 128  27  tc   128 128 64 8
      5120  64 128  27  tc   128 128 32 8
      5120 128 128  27  tc   128 128 32 8
      5120 256 128  27  tc   128 128 64 8
      5461  32  64  27  tc   128  64 32 8
      5461  64  64  27  tc   128  64 32 8
      5461 256  64  27  tc   128  64 32 8
      6144  64 128  27  tc   128 128 32 8
      6144 128 128  27  tc   128 128 32 8
      6144 256 128  27  tc   128 128 64 8
      6826  32  64  27  tc   128  64 32 8
      6826  64  64  27  tc   128  64 32 8
      6826 256  64  27  tc   128  64 32 8
      7168  64 128  27  tc   128 128 32 8
      7168 128 128  27  tc   128 128 32 8
      7168 256 128  27  tc   128 128 64 8
      8192   1  32 125  cin1 128  32  1 1
      8192  32  32  27  tc   128  32 32 4
      8192  32  64  27  tc   128  64 32 4
      8192  64  64  27  tc   128  64 32 4
      8192  64 128  27  tc   128 128 32 4
      8192 128  64  27  tc   128  64 32 4
      8192 128 128  27  tc   128 128 32 4
      8192 128 256  27  tc   128 128 64 2
      8192 256  64  27  tc   128  64 32 4
      8192 256 128  27  tc   128 128 64 4
      8192 256 256  27  tc   128 128 64 2
      9557  32  64  27  tc   128  64 32 4
      9557  64  64  27  tc   128  64 32 4
      9557 256  64  27  tc   128  64 32 4
     10922  32  64  27  tc   128  64 32 4
     10922  64  64  27  tc   128  64 32 4
     10922 256  64  27  tc   128  64 32 4
     12288   1  32 125  cin1 128  32  1 1
     12288  32  32  27  tc   128  32 32 4
     12288  64  64  27  tc   128  64 32 4
     12288 128  64  27  tc   128  64 32 4
     13653  32  64  27  tc   128  64 32 4
     13653  64  64  27  tc   128  64 32 4
     13653 256  64  27  tc   128  64 32 4
     16384   1  32 125  cin1 128  32  1 1
     16384  32  32  27  tc   128  32 32 2
     16384  32  64  27  tc   128  64 32 2
     16384  64  64  27  tc   128  64 32 2
     16384  64 128  27  tc   128 128 32 2
     16384  64 256  27  tc   128 128 32 1
     16384 128  64  27  tc   128  64 32 2
     16384 128 128  27  tc   128 128 32 2
     16384 256  64  27  tc   128  64 32 4
     16384 256 128  27  tc   128 128 64 2
     19114  32  64  27  tc   128  64 32 2
     19114  64  64  27  tc   128  64 32 2
     19114 256  64  27  tc   128  64 32 4
     20480   1  32 125  cin1 128  32  1 1
     20480  32  32  27  tc   128  32 32 2
     20480  64  64  27  tc   128  64 32 2
     20480 128  64  27  tc   128  64 32 2
     21845  32  64  27  tc   128  64 32 2
     21845  64  64  27  tc   128  64 32 2
     21845 256  64  27  tc   128  64 32 4
     24576   1  32 125  cin1 128  32  1 1
     24576  32  32  27  tc   128  32 32 2
     24576  64  64  27  tc   128  64 32 2
     24576 128  64  27  tc   128  64 32 2
     28672   1  32 125  cin1 128  32  1 1
     28672  32  32  27  tc   128  32 32 2
     28672  64  64  27  tc   128  64 32 2
     28672 128  64  27  tc   128  64 32 2
     32768   1  32 125  cin1 128  32  1 1
     32768  32  32  27  tc   128  32 32 1
     32768  32  64  27  tc   128  64 32 1
     32768  64  64  27  tc   128  64 32 1
     32768  64 128  27  tc   128 128 32 1
     32768 128  64  27  tc   128  64 32 2
     32768 128 256  27  tc   128 128 64 1
     32768 256  64  27  tc   128  64 32 4
     32768 256 256  27  tc   128 128 64 2
     40960   1  32 125  cin1 128  32  1 1
     40960  32  32  27  tc   128  32 32 1
     40960  64  64  27  tc   128  64 32 1
     40960 128  64  27  tc   128  64 32 2
     49152   1  32 125  cin1 128  32  1 1
     49152  32  32  27  tc   128  32 32 1
     49152  64  64  27  tc   128  64 32 1
     49152 128  64  27  tc   128  64 32 2
     57344   1  32 125  cin1 128  32  1 1
     57344  32  32  27  tc   128  32 32 1
     57344  64  64  27  tc   128  64 32 1
     57344 128  64  27  tc   128  64 32 2
     65536   1  32 125  cin1 128  32  1 1
     65536  32  32  27  tc   128  32 32 1
     65536  64  32  27  tc   128  32 32 1
     65536  64  64  27  tc   128  64 32 1
     65536  64 128  27  tc   128 128 32 1
     65536 128  64  27  tc   128  64 32 2
     65536 128 128  27  tc   128 128 32 2
     65536 256 128  27  tc   128 128 64 2
    131072   1  32 125  cin1 128  32  1 1
    131072  32  32  27  tc   128  32 32 1
    131072  32  64  27  tc   128  64 32 1
    131072  64  64  27  tc   128  64 32 1
    131072 128  64  27  tc   128  64 32 2
    131072 256  64  27  tc   128  64 32 4
"""
TABLE = {}
for _line in PLANS.strip().splitlines():
    _n, _ci, _co, _k, _v, _bm, _bn, _bk, _s = _line.split()
    TABLE[(int(_n), int(_ci), int(_co), int(_k))] = ConvPlan(_v, int(_bm), int(_bn),
                                                            int(_bk), int(_s))

SLOTS = [8192 + 4096 * i for i in range(7)]
# each cell's padded row counts and level divisors: pair buckets of two
# fragments, single fragments, KITTI's and the training batch's sides
CELLS = {"3dmatch-pair": [(2 * s, (1, 3, 8, 20)) for s in SLOTS],
         "kitti-pair": [(131072, (1, 1, 2, 4))],
         "3dmatch-train": [(65536, (1, 2, 4, 8))],
         "3dmatch-extract": [(s, (1, 3, 8, 20)) for s in SLOTS]}


def shapes(cell):
    """(n_out, cin, cout, k_vol) of the cell's kernel-A calls: conv1 (k 125,
    one channel), the 20 k3 convs and, in training, their dX."""
    out = set()
    for n, divisors in CELLS[cell]:
        caps = level_capacities(n, divisors)
        out.add((caps[0], 1, 32, 125))
        for _, level, kind, cin, cout in MAIN_PATH_CONVS:
            out.add((caps[level], cin, cout, 27))
            if cell == "3dmatch-train":
                rows = {"down": level - 1, "up": level + 1}.get(kind, level)
                out.add((caps[rows], cout, cin, 27))
    return sorted(out)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_plans_of_the_cells_are_unchanged(cell):
    got = {s: conv_plan(*s, torch.bfloat16) for s in shapes(cell)}
    assert all(s in TABLE for s in got)
    assert got == {s: TABLE[s] for s in got}
    assert all(p.variant in ("tc", "cin1") for p in got.values())
