"""The arithmetic the per-layer metrics' readers share (``metrics/*.py``):
each reader names its peaks, with their source, and calls one of these on
the run it is handed (``harness.Reading``)."""
from __future__ import annotations

from benchlib import arith

KERNEL_A = ("gather_gemm",)                  # csrc/sparse_conv.cu
KERNEL_B = ("flash_nn", "nn_transpose")      # csrc/flash_nn.cu


def idle_share(run) -> float:
    """1 - the union of every kernel, copy and set interval over the traced
    window's wall time, in %."""
    return 100.0 * (1.0 - arith.busy_s(run.trace) / arith.window_s(run.trace))


def mfu(run, peak_flops_s: float) -> float:
    """The traced units' operations (``arith.unit_flops``) over the window's
    seconds times the peak, in %."""
    flops = sum(arith.unit_flops(w) for w in run.work)
    return 100.0 * flops / (arith.window_s(run.trace) * peak_flops_s)


def kernel_a_roofline(run, peak_bytes_s: float, peak_flops_s: float, dx: bool = False):
    """Kernel A's bounds (each launch's max of bytes and operations over
    their peaks) over its device time, in %: the traced units' k3 convs,
    and with ``dx`` their dX convs."""
    convs = [c for w in run.work for c in w["convs"] + (w["dx"] if dx else [])
             if c["path"] in ("A", "dX")]
    by_bytes = sum(arith.kernel_a_bytes(c) / peak_bytes_s for c in convs)
    by_ops = sum(arith.conv_flops(c) / peak_flops_s for c in convs)
    run.note(f"kernel A: bytes bound {by_bytes * 1e3:.3f} ms, operations bound "
             f"{by_ops * 1e3:.3f} ms over {len(convs)} convs")
    bounds = [max(arith.kernel_a_bytes(c) / peak_bytes_s, arith.conv_flops(c) / peak_flops_s)
              for c in convs]
    return arith.roofline_share(bounds, arith.device_seconds(run.trace, KERNEL_A))


def kernel_b_roofline(run, peak_bytes_s: float, peak_flops_s: float):
    """Kernel B's bounds (each call's max of bytes and operations over their
    peaks) over its device time, in %."""
    calls = [x for w in run.work for x in w["nn"]]
    by_bytes = sum(arith.nn_bytes(*x) / peak_bytes_s for x in calls)
    by_ops = sum(arith.nn_flops(*x) / peak_flops_s for x in calls)
    run.note(f"kernel B: bytes bound {by_bytes * 1e3:.3f} ms, operations bound "
             f"{by_ops * 1e3:.3f} ms over {len(calls)} calls")
    bounds = [max(arith.nn_bytes(*x) / peak_bytes_s, arith.nn_flops(*x) / peak_flops_s)
              for x in calls]
    return arith.roofline_share(bounds, arith.device_seconds(run.trace, KERNEL_B))
