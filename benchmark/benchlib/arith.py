"""The yardstick's arithmetic: operations and bytes of a unit of work, and
the shares of a traced window that the per-layer metrics report.

A unit's work is described by the cell's driver module from the benchmark's own
reference structures (``reference.voxels`` pyramids), never from the
program's: ``conv_stats`` of each sparse conv's map, the image and fusion
shapes, the nearest-neighbour calls. The kernel-A byte count is frozen from
the program's ``imfnet_tpu_torch/sparse/roofline.py::conv_traffic_bytes``
(each input read once, each output written once, the map's distinct rows
and live offsets only). Operations are counted the same whatever
implements them: 2 per multiply-add.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

from benchlib.trace import Trace, clip, union_ns


def conv_stats(name: str, nbr: torch.Tensor, n_in: int, cin: int, cout: int,
               path: str) -> Dict:
    """The numbers of one sparse conv that its bytes and operations need.
    ``path``: "A" for a forward conv that kernel A runs, "dX" for kernel A
    through the map's inverse in a backward, "plain" for a plain product."""
    live = nbr >= 0
    return {"name": name, "n_out": int(nbr.shape[0]), "k": int(nbr.shape[1]),
            "n_in": int(n_in), "cin": cin, "cout": cout, "path": path,
            "live": int(live.sum()), "rows": int(torch.unique(nbr[live]).numel()),
            "offsets": int(live.any(dim=0).sum())}


def kernel_a_bytes(c: Dict, itemsize: int = 2) -> int:
    """HBM bytes of one kernel-A conv: the x rows the map names, the int32
    map, the weight offsets with a live entry, the f32 output."""
    return (c["rows"] * c["cin"] * itemsize + c["n_out"] * c["k"] * 4
            + c["offsets"] * c["cin"] * c["cout"] * itemsize + c["n_out"] * c["cout"] * 4)


def conv_flops(c: Dict) -> int:
    return 2 * c["live"] * c["cin"] * c["cout"]


def nn_bytes(nq: int, nr: int, d: int) -> int:
    """Kernel B: queries and references read once (f32), index and d²
    written once per query."""
    return (nq + nr) * d * 4 + nq * 8


def nn_flops(nq: int, nr: int, d: int) -> int:
    return 2 * nq * nr * d


def resnet_flops(b: int, h: int, w: int, stages=(3, 4), widths=(64, 128)) -> int:
    """ResNet-34's stem and its first ``len(stages)`` stages on b images."""
    def conv(ho, wo, cin, cout, k):
        return 2 * ho * wo * cin * cout * k * k

    h, w = (h + 1) // 2, (w + 1) // 2
    total = conv(h, w, 3, 64, 7)
    h, w = (h + 1) // 2, (w + 1) // 2          # max pool
    cin = 64
    for i, (n, width) in enumerate(zip(stages, widths)):
        for j in range(n):
            if i > 0 and j == 0:
                h, w = (h + 1) // 2, (w + 1) // 2
            total += conv(h, w, cin, width, 3) + conv(h, w, width, width, 3)
            if j == 0 and (i > 0 or width != 64):
                total += conv(h, w, cin, width, 1)
            cin = width
    return b * total


def fusion_flops(m: int, t: int, lat: int = 256, dim: int = 128) -> int:
    """One cross-attention block (one head of lat/2) with its GEGLU
    feed-forward: m queries over t tokens."""
    inner, ff = lat // 2, 4 * lat
    return 2 * (m * lat * inner + t * dim * 2 * inner + 2 * m * t * inner
                + m * inner * lat + m * lat * 2 * ff + m * ff * lat)


def unit_flops(work: Dict) -> int:
    """Model operations of one unit: every conv, the 1x1 products, the
    image trunk, the fusion and the nearest-neighbour calls, the model's
    part taken ``passes`` times (3 for a training step)."""
    model = sum(conv_flops(c) for c in work["convs"])
    model += sum(2 * n * ci * co for n, ci, co in work["dense"])
    model += sum(resnet_flops(*img) for img in work["images"])
    model += sum(fusion_flops(m, t) for m, t in work["fusion"])
    return model * work.get("passes", 1) + sum(nn_flops(*x) for x in work["nn"])


# ---- readings of a traced window -------------------------------------------

def device_seconds(tr: Trace, names: Iterable[str]) -> float:
    """Seconds of the window's device operations whose name holds any of
    ``names``."""
    names = tuple(names)
    ops = [o for o in tr.ops if any(n in o.name for n in names)]
    return sum(b - a for a, b in clip(ops, tr.window)) / 1e9


def window_s(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e9


def busy_s(tr: Trace) -> float:
    """Union of every kernel, copy and set interval in the window."""
    return union_ns(clip(tr.ops, tr.window)) / 1e9


def roofline_share(bounds_s: List[float], time_s: float) -> Optional[float]:
    """Percent: the least time the launches could take over the time they
    took. None where the window holds none of them."""
    if time_s <= 0 or not bounds_s:
        return None
    return 100.0 * sum(bounds_s) / time_s
