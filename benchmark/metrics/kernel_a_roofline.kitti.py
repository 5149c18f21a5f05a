"""kernel_a_roofline.kitti (%): kernel A's share of its roofline on eval-kitti's pair path.
Each launch's bound is max(bytes / 3.35 TB/s, operations / 989 TFLOP/s);
bytes and operations of each k3 conv come from ``benchlib.arith`` on the
benchmark's own maps of the traced pairs. The share is the sum of the
bounds over kernel A's device time in the traced window (kernels named
``gather_gemm*`` in ``csrc/sparse_conv.cu``). Moves kitti_pairs_per_s."""
from benchlib import readers

PEAK_BYTES_S = 3.35e12     # H100 SXM data sheet: HBM3
PEAK_FLOPS_S = 989e12      # H100 SXM data sheet: dense bf16


def read(run):
    return readers.kernel_a_roofline(run, PEAK_BYTES_S, PEAK_FLOPS_S)
