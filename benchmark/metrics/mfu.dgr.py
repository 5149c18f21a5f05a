"""mfu.dgr (%): DGR's operations in the traced window over the window's
seconds times 989 TFLOP/s: every 6-D sparse conv (2 · live map entries ·
cin · cout, from the benchmark's own maps), the two 1x1 products and
2·N·M·D of the one-way nearest-neighbour search over valid rows; no image
trunk or fusion (``benchlib.arith.unit_flops``). Moves pairs_per_s."""
from benchlib import readers

PEAK_FLOPS_S = 989e12      # H100 SXM data sheet: dense bf16


def read(run):
    return readers.mfu(run, PEAK_FLOPS_S)
