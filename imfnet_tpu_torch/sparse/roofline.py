"""Memory-traffic model of the sparse-conv forward: the roofline
denominator (``imfnet_tpu.sparse.roofline``).

The bytes each conv must move through the card's memory on the port's path,
kernel A (``csrc/sparse_conv.cu``), with each input read once and each output
written once:

  per k > 1 conv:  the map (int32 [n_out, k]) once; the x rows the map names
                   (all n_in without the map; with ``nbr=``, the distinct
                   rows of its live entries: each level's capacity padding
                   is never read); W once (with ``nbr=``, only the offsets
                   with a live entry); the f32 output once
  k = 1:           a plain GEMM: x read, W read, the f32 output written
  conv1 occupancy: the map and the output (the features are all ones)

The JAX package's model counts the TPU kernel's padded windows instead,
so the two byte counts are not comparable. The norms, the skip
concatenations, the image trunk and the fusion are left out (``dense_bytes``
adds them), so the forward's share of the memory rate is a lower bound.

The card's peaks below are the NVIDIA H100 SXM data sheet's dense figures,
used for bounds only.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core operations a second
PEAK_F32_FLOPS = 67e12     # f32 operations a second (no tensor cores)
PEAK_BYTES = 3.35e12       # HBM3 bytes a second


def conv_traffic_bytes(n_out: int, n_in: int, k: int, cin: int, cout: int, *,
                       itemsize: int = 2, occupancy: bool = False,
                       nbr: Optional[torch.Tensor] = None) -> int:
    """Bytes one sparse conv moves on kernel A's path (module docstring).
    ``nbr`` (the conv's map) counts only the x rows and W offsets it names;
    without it every row and offset is counted."""
    out_b = n_out * cout * 4
    if k == 1:
        return n_in * cin * itemsize + cin * cout * itemsize + out_b
    if occupancy:
        return n_out * k * 4 + out_b
    if nbr is None:
        rows, offsets = n_in, k
    else:
        live = nbr >= 0
        rows = int(torch.unique(nbr[live]).numel())
        offsets = int(live.any(dim=0).sum())
    return rows * cin * itemsize + n_out * k * 4 + offsets * cin * cout * itemsize + out_b


class ConvCall(NamedTuple):
    """One conv of a forward: its name, sizes and map (None for k = 1)."""

    name: str
    n_out: int
    n_in: int
    k: int
    cin: int
    cout: int
    nbr: Optional[torch.Tensor]
    occupancy: bool


def _conv(name, module, nbr, n_out, n_in, occupancy=False) -> ConvCall:
    w = module.weight
    k, cin, cout = (1, *w.shape) if w.dim() == 2 else tuple(w.shape)
    return ConvCall(name, n_out, n_in, k, cin, cout, nbr, occupancy)


def forward_convs(model, pyr) -> List[ConvCall]:
    """The convs of one ``ResUNetIMF`` forward over ``pyr``, in order (the
    walk of ``models/resunet.py::ResUNetIMF.forward``; reference
    `model/resunet.py:163-235`). conv1 takes the occupancy path when the
    model does."""
    lv = pyr.levels
    n = [int(level.coords.shape[0]) for level in lv]
    occ = bool(model.conv1_occupancy and model.in_channels == 1)
    calls = [_conv("conv1", model.conv1, pyr.k5_l0, n[0], n[0], occ)]

    def block(name, module, i):
        for j, conv in enumerate((module.conv0, module.conv1)):
            calls.append(_conv(f"{name}.conv{j}", conv, lv[i].k3_same, n[i], n[i]))

    block("block1", model.block1, 0)
    for i, (conv, blk) in enumerate(((model.conv2, model.block2), (model.conv3, model.block3),
                                     (model.conv4, model.block4)), start=1):
        calls.append(_conv(f"conv{i + 1}", conv, lv[i].down, n[i], n[i - 1]))
        block(f"block{i + 1}", blk, i)
    for i, (conv, blk) in zip((2, 1, 0), ((model.conv4_tr, model.block4_tr),
                                          (model.conv3_tr, model.block3_tr),
                                          (model.conv2_tr, model.block2_tr))):
        calls.append(_conv(f"conv{i + 2}_tr", conv, lv[i].up, n[i], n[i + 1]))
        block(f"block{i + 2}_tr", blk, i)
    calls.append(_conv("conv1_tr", model.conv1_tr, None, n[0], n[0]))
    calls.append(_conv("final", model.final, None, n[0], n[0]))
    return calls


def forward_hbm_bytes(model, pyr, *, itemsize: int = 2, dense_bytes: float = 0.0) -> float:
    """Bytes the sparse-conv stack of one ``ResUNetIMF`` forward over
    ``pyr`` moves on kernel A's path, each conv counted through its map
    (``conv_traffic_bytes(..., nbr=)``); ``dense_bytes`` adds a figure
    measured for the image trunk and the fusion."""
    total = sum(conv_traffic_bytes(c.n_out, c.n_in, c.k, c.cin, c.cout, itemsize=itemsize,
                                   occupancy=c.occupancy, nbr=c.nbr)
                for c in forward_convs(model, pyr))
    return float(total) + float(dense_bytes)
