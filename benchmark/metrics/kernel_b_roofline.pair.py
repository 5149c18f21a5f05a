"""kernel_b_roofline.pair (%): kernel B's share of its roofline on the 3DMatch pair path.
Each nearest-neighbour call's bound is max(bytes / 3.35 TB/s, operations /
67 TFLOP/s): queries and references read once, index and d² written once,
2·N·M·D operations over the valid queries and references. The share is
the sum of the bounds over kernel B's device time in the traced window
(``flash_nn*`` and its ``nn_transpose*`` pre-pass in ``csrc/flash_nn.cu``).
Moves pairs_per_s."""
from benchlib import readers

PEAK_BYTES_S = 3.35e12     # H100 SXM data sheet: HBM3
PEAK_FLOPS_S = 67e12       # H100 SXM data sheet: f32, no tensor cores


def read(run):
    return readers.kernel_b_roofline(run, PEAK_BYTES_S, PEAK_FLOPS_S)
