"""kernel_a_roofline.train (%): kernel A's share of its roofline in the
training step: every forward conv that kernel A runs (conv1 through its
one-channel variant, the 20 k3 convs of each side) and every dX conv
(through the map's exact inverse, input and output widths swapped). Each
launch's bound is max(bytes / 3.35 TB/s, operations / 989 TFLOP/s) from
``benchlib.arith`` on the benchmark's own maps; the share is the sum of
the bounds over kernel A's device time in the traced window (kernels
named ``gather_gemm*`` in ``csrc/sparse_conv.cu``). Moves
train_steps_per_s."""
from benchlib import readers

PEAK_BYTES_S = 3.35e12     # H100 SXM data sheet: HBM3
PEAK_FLOPS_S = 989e12      # H100 SXM data sheet: dense bf16


def read(run):
    return readers.kernel_a_roofline(run, PEAK_BYTES_S, PEAK_FLOPS_S, dx=True)
