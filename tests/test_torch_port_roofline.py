"""The port's memory-traffic model (``sparse/roofline.py``), after
``tests/test_roofline.py``: the k = 1 and occupancy formulas, the count
through a map, monotone growth in the rows, and ``forward_hbm_bytes``
against the convs a forward hook sees in a real forward.

No number is compared with the JAX package's ``roofline``: its model counts
the TPU kernel's padded windows (blocks of rows times window widths), where
the port's counts what kernel A must move (the map, the rows it names, W and
the output, each once), so the two differ by design."""
import numpy as np
import pytest
import torch

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.models.layers import SparseConv
from imfnet_tpu_torch.sparse.coords import SparseVoxels
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid
from imfnet_tpu_torch.sparse.roofline import (PEAK_BYTES, conv_traffic_bytes, forward_convs,
                                              forward_hbm_bytes)
from imfnet_tpu_torch.train.step import level_capacities
from imfnet_tpu_torch.train.trainer import build_model_from_config


def test_conv_traffic_bytes_formulas():
    # 1x1 conv: a plain GEMM's read and write
    assert conv_traffic_bytes(1000, 1000, 1, 64, 32) == 1000 * 64 * 2 + 64 * 32 * 2 + 1000 * 32 * 4
    assert conv_traffic_bytes(10, 10, 1, 8, 4, itemsize=4) == 10 * 8 * 4 + 8 * 4 * 4 + 10 * 4 * 4
    # occupancy conv1: the map and the output only
    assert conv_traffic_bytes(1000, 1000, 125, 1, 32, occupancy=True) == 1000 * 125 * 4 + 1000 * 32 * 4
    # without a map: every row and offset once
    assert conv_traffic_bytes(500, 800, 27, 32, 64) == (800 * 32 * 2 + 500 * 27 * 4
                                                        + 27 * 32 * 64 * 2 + 500 * 64 * 4)
    assert PEAK_BYTES == 3.35e12


def test_conv_traffic_bytes_through_a_map():
    """With ``nbr=`` only the distinct rows the live entries name and the
    offsets with a live entry are read; the map and output stay whole."""
    nbr = torch.full((6, 27), -1, dtype=torch.int32)
    nbr[0, 3] = 5
    nbr[1, 3] = 5
    nbr[2, 13] = 7
    nbr[4, 20] = 1
    got = conv_traffic_bytes(6, 100, 27, 16, 8, nbr=nbr)
    assert got == 3 * 16 * 2 + 6 * 27 * 4 + 3 * 16 * 8 * 2 + 6 * 8 * 4
    full = torch.arange(6 * 27, dtype=torch.int32).reshape(6, 27) % 100
    assert conv_traffic_bytes(6, 100, 27, 16, 8, nbr=full) <= conv_traffic_bytes(6, 100, 27, 16, 8)


@pytest.mark.parametrize("kw", [dict(k=27, cin=32, cout=64), dict(k=1, cin=64, cout=32),
                                dict(k=125, cin=1, cout=32, occupancy=True)])
def test_bytes_grow_with_the_rows(kw):
    k = kw.pop("k")
    cin, cout = kw.pop("cin"), kw.pop("cout")
    sizes = [256, 1024, 4096, 65536]
    out_rows = [conv_traffic_bytes(n, 4096, k, cin, cout, **kw) for n in sizes]
    in_rows = [conv_traffic_bytes(4096, n, k, cin, cout, **kw) for n in sizes]
    assert all(a < b for a, b in zip(out_rows, out_rows[1:]))
    assert all(a <= b for a, b in zip(in_rows, in_rows[1:]))
    assert (conv_traffic_bytes(4096, 4096, k, cin, 2 * cout, **kw)
            > conv_traffic_bytes(4096, 4096, k, cin, cout, **kw))


@pytest.mark.parametrize("occupancy", [True, False])
def test_forward_hbm_bytes_equals_the_hooked_convs(occupancy):
    """Every SparseConv call of a real forward, seen by a forward hook,
    counted through its map, sums to ``forward_hbm_bytes``; the walk names
    the same convs in the same order."""
    cfg = threedmatch_config(batch_size=1, conv1_kernel_size=3, model_n_out=16,
                             max_points=512, voxel_size=0.05, compute_dtype="float32")
    model = build_model_from_config(cfg, eval_fast=occupancy).eval()
    b = synthetic_batch(np.random.RandomState(0), batch_size=1, n_points=200, n_pad=512,
                        image_hw=(24, 32), device="cpu")
    pyr = build_pyramid(b.coords0, b.n0, conv1_kernel_size=3,
                        level_capacity=level_capacities(512))
    seen = []

    def hook(module, args, kwargs, out):
        feats = args[0]
        nbr = args[1] if len(args) > 1 else kwargs.get("nbr")
        occ = bool(kwargs.get("occupancy", False)) and module.in_channels == 1
        w = module.weight
        k, cin, cout = (1, *w.shape) if w.dim() == 2 else tuple(w.shape)
        seen.append((out.shape[0], feats.shape[0], k, cin, cout, nbr, occ))

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in model.modules() if isinstance(m, SparseConv)]
    with torch.no_grad():
        model(SparseVoxels(b.coords0, b.feats0, b.n0), pyr, b.image0)
    for h in hooks:
        h.remove()
    walk = forward_convs(model, pyr)
    assert len(seen) == len(walk) == 23
    for (n_out, n_in, k, cin, cout, nbr, occ), c in zip(seen, walk):
        assert (n_out, n_in, k, cin, cout, occ) == (c.n_out, c.n_in, c.k, c.cin, c.cout,
                                                    c.occupancy), c.name
        assert (nbr is None and c.nbr is None) or nbr is c.nbr, c.name
    want = sum(conv_traffic_bytes(n_out, n_in, k, cin, cout, occupancy=occ, nbr=nbr)
               for n_out, n_in, k, cin, cout, nbr, occ in seen)
    assert forward_hbm_bytes(model, pyr) == float(want) > 0
    assert forward_hbm_bytes(model, pyr, dense_bytes=10.0) == float(want) + 10.0
    # the maps leave capacity padding unread: below the count without them
    blind = sum(conv_traffic_bytes(c.n_out, c.n_in, c.k, c.cin, c.cout, occupancy=c.occupancy)
                for c in walk)
    assert want < blind
