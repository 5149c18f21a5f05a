"""kernel_a_roofline.dgr (%): kernel A's share of its roofline at the 20
6-D k3 convs of DGR's inlier network (``kitti-dgr-pair``). Each conv's
bound is max(bytes / 3.35 TB/s, 2 · live entries · cin · cout / 989
TFLOP/s), bytes and live entries from the benchmark's own 6-D maps of the
traced pairs (``benchlib.dgr_arith``: the [N, 729] map once, the rows it
names, the live weight offsets, the output); the share is their sum over
the device time of kernel A's wide-K variant (``gather_gemm_tcw``) in the
traced window. Moves pairs_per_s."""
from benchlib import dgr_arith

PEAK_BYTES_S = 3.35e12     # H100 SXM data sheet: HBM3
PEAK_FLOPS_S = 989e12      # H100 SXM data sheet: dense bf16


def read(run):
    return dgr_arith.kernel_a_roofline(run, PEAK_BYTES_S, PEAK_FLOPS_S)
