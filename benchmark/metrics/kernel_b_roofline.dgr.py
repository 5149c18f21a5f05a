"""kernel_b_roofline.dgr (%): kernel B's share of its roofline on DGR's pair
path: the one-way nearest-neighbour search, each valid source voxel's
nearest valid target descriptor (131 072^2 x 32 padded, about 67 000 valid
a side). Its bound is max(bytes / 3.35 TB/s, operations / 67 TFLOP/s):
queries and references read once, index and d^2 written once, 2·N·M·D
operations over the valid rows (``benchlib.dgr_arith.work``'s ``nn``). The
share is the bounds' sum over kernel B's device time in the traced window
(``flash_nn*`` and its ``nn_transpose*`` pre-pass in ``csrc/flash_nn.cu``).
Moves pairs_per_s."""
from benchlib import readers

PEAK_BYTES_S = 3.35e12     # H100 SXM data sheet: HBM3
PEAK_FLOPS_S = 67e12       # H100 SXM data sheet: f32, no tensor cores


def read(run):
    return readers.kernel_b_roofline(run, PEAK_BYTES_S, PEAK_FLOPS_S)
