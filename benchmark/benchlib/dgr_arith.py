"""The arithmetic of Deep Global Registration's cell (``kitti-dgr-pair``):
a pair's work from the benchmark's own 6-D pyramid (``reference.dgr``),
and the readings of its per-layer metrics. Bytes and operations of a
sparse conv are ``benchlib.arith``'s: the map read once, the input rows it
names once, the weight offsets with a live entry once, the f32 output
once; 2 operations a multiply-add of a live entry.

Kernel A's wide-K variant (``gather_gemm_tcw``, the 6-D k3 convs) reads
the whole ``[N, 729]`` map, in chunks of offsets: the bytes counted are
that map's, once, so the share stays under what the kernel moves.
"""
from __future__ import annotations

from typing import Dict, Optional

from benchlib import arith
from benchlib import program_trace
from reference import dgr as ref_dgr

KERNEL_A_WIDE = ("gather_gemm_tcw",)       # csrc/sparse_conv.cu, 6-D k3 convs


def work(pyr, m: Dict, n0: int, n1: int, d: int) -> Dict:
    """One pair's work: the network's sparse convs (conv1 through the
    cin = 1 variant, the rest through the wide-K one), its two 1x1
    products, and the one-way nearest-neighbour search over valid rows."""
    convs = [arith.conv_stats(name, nbr, n_in, ci, co, "cin1" if name == "conv1" else "A")
             for name, nbr, n_in, ci, co in ref_dgr.conv_calls(pyr, m)]
    n = len(pyr.tables[0])
    ch, tr = m["channels"], m["tr_channels"]
    return {"convs": convs, "dense": [(n, ch[0] + tr[1], tr[0]), (n, tr[0], m["out_channels"])],
            "images": [], "fusion": [], "nn": [(n0, n1, d)]}


def kernel_a_roofline(run, peak_bytes_s: float, peak_flops_s: float) -> Optional[float]:
    """The 6-D k3 convs' bounds (each its max of bytes and operations over
    their peaks) over the wide-K variant's device time, in %."""
    convs = [c for w in run.work for c in w["convs"] if c["path"] == "A"]
    bounds = [max(arith.kernel_a_bytes(c) / peak_bytes_s, arith.conv_flops(c) / peak_flops_s)
              for c in convs]
    run.note(f"kernel A (6-D): bytes bound "
             f"{sum(arith.kernel_a_bytes(c) for c in convs) / peak_bytes_s * 1e3:.3f} ms, "
             f"operations bound {sum(arith.conv_flops(c) for c in convs) / peak_flops_s * 1e3:.3f}"
             f" ms over {len(convs)} convs")
    return arith.roofline_share(bounds, arith.device_seconds(run.trace, KERNEL_A_WIDE))


def counter_share(num: str, den: str) -> Optional[float]:
    """100 × counter ``num`` over counter ``den`` of the program's record;
    None where it kept neither."""
    rec = program_trace.record()
    total = 0 if rec is None else rec["counters"].get(den, 0)
    return 100.0 * rec["counters"].get(num, 0) / total if total else None


def stage_ms(run, stage: str) -> Optional[float]:
    rec = program_trace.record()
    return None if rec is None else program_trace.stage_ms(run, rec, stage)
