"""mfu.extract (%): the model's operations in the traced window on the extraction path
over the window's seconds times 989 TFLOP/s: every sparse conv (2 · live
map entries · cin · cout, from the benchmark's own maps), the 1x1
products, the ResNet-34 trunk and the fusion from their shapes, and 2·N·M·D
a nearest-neighbour direction (``benchlib.arith.unit_flops``). Moves
fragments_per_s."""
from benchlib import readers

PEAK_FLOPS_S = 989e12      # H100 SXM data sheet: dense bf16


def read(run):
    return readers.mfu(run, PEAK_FLOPS_S)
