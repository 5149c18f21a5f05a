"""Deep Global Registration (Choy, Dong and Koltun, CVPR 2020): a learned
inlier weighting of descriptor correspondences and a weighted Procrustes
solve, in place of RANSAC.

``DGRRegistrar`` takes two voxelized scans, their voxels' points and
descriptors as host arrays (the layout a descriptor file and
``eval.threedmatch``'s register give), and returns the pose that maps scan
0 onto scan 1, each correspondence's weight and the weights' sum. Per pair
it runs, in one CUDA graph on the card (``utils.graphs.jit``):

1. ``dgr.nn``: each valid source voxel's nearest valid target descriptor
   through kernel B (``match.nn.nn_auto`` by way of
   ``eval.registration.nn_auto``; DGR's ``inlier_knn`` 1);
2. ``dgr.coords``: one 6-D point a correspondence,
   ``(floor(p / v), floor(q / v))`` of the source voxel's point p and its
   match's point q, key-sorted (``sparse.coords``' 6-D keys); its feature
   is one (``inlier_feature_type`` ones);
3. ``dgr.pyramid``: the 6-D coordinate pyramid (the search builder at
   every level's capacity, ``train.step.make_pyramid_fn(dim=6)``: 729
   offsets a k3 map, conv1 k3 sharing level 0's map);
4. ``dgr.inlier``: ``ResUNetBN2C`` at D = 6 with one output logit and no
   feature normalization, its 20 k3 convs through kernel A's wide-K
   walk (a residual block's two convs sharing one list build), conv1
   through its cin = 1 variant;
5. ``dgr.procrustes``: ``w = sigmoid(logit)``, set to 0 below
   ``clip_weight_thresh``, then ``match.procrustes.kabsch_umeyama`` with
   those weights.

The names in parentheses are DGR's options (``config.py``,
``model/resunet.py``). DGR's safeguard (RANSAC where Σw falls below
``wsum_threshold``) and its pose refinement are left out.

While tracing (``utils.timer``), the span ``dgr.pad`` holds a call's host
work before the graph (both scans padded, pinned and copied to the card),
the graph's stages are the five above and
its device counters ``dgr.corr_valid`` (correspondences) and ``dgr.rows_valid.
<level>`` (the pyramid's valid rows a level); kernel A's wide-K launches
add ``conv.slots_walked``, ``conv.entries_live``, ``conv.entries_waited``
and ``conv.map_slots`` (the live entries of the 6-D maps they read, over
the rows their products cover and over N × 729 a map; ``sparse.conv_kernel``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from imfnet_tpu_torch.config import Config, dgr_kitti_config
from imfnet_tpu_torch.eval import registration
from imfnet_tpu_torch.match.nn import queries_valid
from imfnet_tpu_torch.match.procrustes import kabsch_umeyama
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.sparse.coords import (SparseVoxels, out_of_range, row_mask,
                                            unique_voxels, voxel_cells)
from imfnet_tpu_torch.sparse.kernel_map import coarse_levels_fit
from imfnet_tpu_torch.train.step import make_pyramid_fn
from imfnet_tpu_torch.utils import timer
from imfnet_tpu_torch.utils.device import resolve_device
from imfnet_tpu_torch.utils.graphs import jit

DIM = 6
CLIP_WEIGHT_THRESH = 0.05      # DGR's clip_weight_thresh


def inlier_model(config: Config) -> torch.nn.Module:
    """DGR's inlier network: ``config.model`` at D = 6, one input channel
    (the ones), ``config.model_n_out`` logits, conv1 of
    ``config.conv1_kernel_size``, no image trunk, no normalization."""
    return load_model(config.model)(
        dim=DIM, in_channels=1, out_channels=config.model_n_out,
        conv1_kernel_size=config.conv1_kernel_size,
        normalize_feature=config.normalize_feature, with_image=False,
        compute_dtype=getattr(torch, config.compute_dtype), bn_momentum=config.bn_momentum)


def correspondence_coords(xyz0: torch.Tensor, xyz1: torch.Tensor, nn: torch.Tensor,
                          voxel_size: float) -> torch.Tensor:
    """int32[N, 7]: (0, floor(p / v), floor(q / v)) of each source row's
    point p and its match's point q."""
    p = voxel_cells(xyz0, voxel_size)
    q = voxel_cells(xyz1.index_select(0, nn), voxel_size)
    return torch.cat([torch.zeros_like(p[:, :1]), p, q], dim=1)


class DGRRegistrar:
    """DGR's registration of scan pairs on ``device`` (default the card;
    ``device="cpu"`` for the plain PyTorch path). ``state_dict`` replaces
    the seeded random weights; ``model`` replaces the network itself (a
    narrower one, for tests). ``graphed`` (on the card) runs the chain as
    one CUDA graph per padded size; ``self.graphed`` is then its
    ``utils.graphs.Graphed``, else None."""

    def __init__(self, config: Optional[Config] = None, *, device=None, state_dict=None,
                 seed: int = 0, clip_weight_thresh: float = CLIP_WEIGHT_THRESH,
                 graphed: bool = True, model: Optional[torch.nn.Module] = None):
        self.device = resolve_device(device)
        self.config = c = config if config is not None else dgr_kitti_config()
        self.clip_weight_thresh = clip_weight_thresh
        if model is None:
            with torch.random.fork_rng(devices=[]), torch.device(self.device):
                torch.manual_seed(seed)
                model = inlier_model(c)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.graphed = (jit(self.chain, clone=True) if graphed and self.device.type == "cuda"
                        else None)

    def pad(self, xyz: np.ndarray, feats: np.ndarray):
        """A scan's points and descriptors padded to ``max_points`` rows on
        the device, and its row count."""
        n, n_pad = len(xyz), self.config.max_points
        if n > n_pad:
            raise ValueError(f"DGRRegistrar: {n} voxels, more than max_points={n_pad}")
        x = np.zeros((n_pad, 3), np.float32)
        f = np.zeros((n_pad, feats.shape[1]), np.float32)
        x[:n], f[:n] = xyz, feats
        pin = self.device.type == "cuda"
        to = (lambda a: torch.from_numpy(a).pin_memory().to(self.device, non_blocking=True)
              ) if pin else (lambda a: torch.from_numpy(a))
        return to(x), to(f), torch.tensor(n, dtype=torch.int32, device=self.device)

    @torch.no_grad()
    def chain(self, xyz0, f0, n0, xyz1, f1, n1) -> Dict[str, torch.Tensor]:
        """The pair on the device: NN, 6-D coordinates, pyramid, inlier
        network, weights and the weighted Procrustes solve (what the graph
        holds). Weights and logits come in source-row order."""
        c = self.config
        n_pad = xyz0.shape[0]
        v0, v1 = row_mask(n_pad, n0), row_mask(xyz1.shape[0], n1)

        timer.stage("dgr.nn")
        with queries_valid(v0):
            nn = registration.nn_auto(f0, f1, v1)[0].long()

        timer.stage("dgr.coords")
        coords = correspondence_coords(xyz0, xyz1, nn, c.voxel_size)
        bad = out_of_range(coords, v0)
        table, sel, n_corr = unique_voxels(coords, v0, n_pad)
        ok = sel >= 0
        src = sel.clamp_min(0)

        timer.stage("dgr.pyramid")
        pyr = make_pyramid_fn(c, n_pad, map_impl="search", dim=DIM)(table, n_corr)
        fits = coarse_levels_fit(pyr)

        timer.stage("dgr.inlier")
        ones = ok[:, None].to(torch.float32)
        logit = self.model(SparseVoxels(table, ones, n_corr), pyr, None)[:, 0]

        timer.stage("dgr.procrustes")
        w = torch.sigmoid(logit)
        w = torch.where(ok & (w >= self.clip_weight_thresh), w, torch.zeros_like(w))
        T = kabsch_umeyama(xyz0.index_select(0, src),
                           xyz1.index_select(0, nn.index_select(0, src)), weights=w)
        # back to source-row order: padding rows all land on one spare row
        to = torch.where(ok, sel, torch.full_like(sel, n_pad))
        weights = w.new_zeros(n_pad + 1).index_copy_(0, to, w)[:n_pad]
        logits = logit.new_zeros(n_pad + 1).index_copy_(0, to, logit)[:n_pad]

        counts = {"dgr.corr_valid": n_corr}
        counts.update({f"dgr.rows_valid.{i}": lv.num_valid for i, lv in enumerate(pyr.levels)})
        timer.count_device(counts)
        return {"transformation": T, "weights": weights, "wsum": w.sum(), "logits": logits,
                "nn": nn, "levels_fit": fits, "out_of_range": bad}

    def __call__(self, xyz0: np.ndarray, feats0: np.ndarray, xyz1: np.ndarray,
                 feats1: np.ndarray) -> Dict[str, np.ndarray]:
        """The pair's pose (4×4, scan 0 onto scan 1), weights (a source
        voxel's, 0 where clipped) and their sum, on the host. Raises where
        a coarse level filled its capacity or a correspondence's 6-D
        coordinate lies outside the key's range."""
        with timer.span("dgr.pad"):
            args = (*self.pad(xyz0, feats0), *self.pad(xyz1, feats1))
        out = (self.graphed or self.chain)(*args)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        if int(host["out_of_range"]):
            raise ValueError(f"DGRRegistrar: {int(host['out_of_range'])} correspondences "
                             f"lie outside the 6-D key's range")
        if not bool(host["levels_fit"]):
            raise ValueError("DGRRegistrar: a coarse level of the 6-D pyramid filled its "
                             "capacity; raise config.level_capacity_divisors")
        n0 = len(xyz0)
        return {"transformation": host["transformation"], "weights": host["weights"][:n0],
                "wsum": host["wsum"]}
