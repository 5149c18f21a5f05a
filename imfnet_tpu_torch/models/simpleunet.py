"""FCGF-style ablation UNets without the image branch
(``imfnet_tpu.models.simpleunet``; reference `model/simpleunet.py:8-541`:
SimpleNet / SimpleNet2 / SimpleNet3 and their BN/IN/B/C/D/E variants).

One module covers all depths: per level a conv and a norm, a decoder of
transpose convs with skip concats of the *pre-ReLU* encoder tensors (the
reference concatenates `out_sN`, norm outputs before the functional ReLU).
SimpleNet and SimpleNet2 end with a k3 ``conv1_tr`` + norm + ReLU and a 1x1
``final`` with bias; SimpleNet3 ends at ``conv1_tr`` (k3) with no final conv.
Every sparse conv runs kernel A and is handed its map's exact inverse, as in
``models.resunet``. Submodule names follow the flax module's, so
``utils.flax_weights`` carries the weights across.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from imfnet_tpu_torch.models.layers import SparseConv, SparseNorm
from imfnet_tpu_torch.sparse.coords import SparseVoxels, row_mask
from imfnet_tpu_torch.sparse.kernel_map import CoordinatePyramid
from imfnet_tpu_torch.sparse.ops import sparse_cat

MAX_BATCH = 1 << 4   # the instance norm's segment count, as the flax module


class SimpleUNetBase(nn.Module):
    """The depth is ``len(channels)``; the pyramid must have that many
    levels (SimpleNet3: 5, ``make_pyramid_fn`` with five
    ``level_capacity_divisors``)."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 32,
        channels: Tuple[int, ...] = (32, 64, 128),
        tr_channels: Tuple[int, ...] = (32, 32, 64),
        norm_type: str = "BN",
        bn_momentum: float = 0.05,
        conv1_kernel_size: int = 5,
        normalize_feature: bool = True,
        has_final: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        ch, tr = channels, tr_channels
        self.depth = len(ch)
        self.normalize_feature = normalize_feature
        self.has_final = has_final

        def conv(cin, cout, k=27, bias=False):
            return SparseConv(cin, cout, k, use_bias=bias, compute_dtype=compute_dtype)

        def norm(c):
            return SparseNorm(norm_type, c, bn_momentum)

        self.conv1 = conv(in_channels, ch[0], conv1_kernel_size ** 3)
        self.norm1 = norm(ch[0])
        for i in range(1, self.depth):
            setattr(self, f"conv{i + 1}", conv(ch[i - 1], ch[i]))
            setattr(self, f"norm{i + 1}", norm(ch[i]))
        for i in range(self.depth - 1, 0, -1):
            cin = ch[i] + (tr[i + 1] if i < self.depth - 1 else 0)
            setattr(self, f"conv{i + 1}_tr", conv(cin, tr[i]))
            setattr(self, f"norm{i + 1}_tr", norm(tr[i]))
        if has_final:
            self.conv1_tr = conv(ch[0] + tr[1], tr[0])
            self.norm1_tr = norm(tr[0])
            self.final = conv(tr[0], out_channels, 1, bias=True)
        else:
            self.conv1_tr = conv(ch[0] + tr[1], out_channels)

    def forward(self, sv: SparseVoxels, pyramid: CoordinatePyramid,
                image: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Descriptors f32[N0, out_channels], padding rows zero; ``image``
        is accepted and unused (no image branch), so the extractors, the
        steps and the trainer call it as they call ``ResUNetIMF``."""
        del image
        lv = pyramid.levels
        if len(lv) < self.depth:
            raise ValueError(f"{type(self).__name__} needs a pyramid of {self.depth} "
                             f"levels, got {len(lv)}: give the config "
                             f"{self.depth} level_capacity_divisors")
        masks, bids = [], []
        for level in lv[:self.depth]:
            m = row_mask(level.coords.shape[0], level.num_valid)
            masks.append(m)
            bids.append(level.coords[:, 0].long())

        def norm(i, name, x):
            return getattr(self, name)(x, masks[i], bids[i], MAX_BATCH, lv[i].num_valid)

        # encoder: conv1, then k3 stride 2 per level; skips are pre-ReLU
        skips = []
        out = norm(0, "norm1", self.conv1(sv.feats, pyramid.k5_l0, nbr_inv=pyramid.k5_l0))
        skips.append(out)
        out = torch.relu(out)
        for i in range(1, self.depth):
            out = getattr(self, f"conv{i + 1}")(out, lv[i].down, nbr_inv=lv[i - 1].up)
            out = norm(i, f"norm{i + 1}", out)
            skips.append(out)
            out = torch.relu(out)

        # decoder: transpose conv + norm + ReLU, then the pre-ReLU skip
        for i in range(self.depth - 1, 0, -1):
            out = getattr(self, f"conv{i + 1}_tr")(out, lv[i - 1].up, nbr_inv=lv[i].down)
            out = torch.relu(norm(i - 1, f"norm{i + 1}_tr", out))
            out = sparse_cat(out, skips[i - 1])

        out = self.conv1_tr(out, lv[0].k3_same, nbr_inv=lv[0].k3_same)
        if self.has_final:
            out = torch.relu(norm(0, "norm1_tr", out))
            out = self.final(out, None, masks[0])

        if self.normalize_feature:
            nrm = out.norm(dim=1, keepdim=True)
            out = out / nrm.clamp_min(1e-12) * masks[0][:, None]
        return out


# Depth presets (`model/simpleunet.py:10-11,154-155,332-333`).
class SimpleNet(SimpleUNetBase):
    pass


class SimpleNet2(SimpleUNetBase):
    def __init__(self, channels=(32, 64, 128, 256), tr_channels=(32, 32, 64, 64), **kw):
        super().__init__(channels=channels, tr_channels=tr_channels, **kw)


class SimpleNet3(SimpleUNetBase):
    def __init__(self, channels=(32, 64, 128, 256, 512),
                 tr_channels=(32, 32, 64, 64, 128), has_final=False, **kw):
        super().__init__(channels=channels, tr_channels=tr_channels,
                         has_final=has_final, **kw)
