"""IMFNet backbone: sparse 3D ResUNet with attention fusion at the bottleneck
(reference `model/resunet.py:25-273`).

Four encoder stages (conv1 k=conv1_kernel_size, conv2..4 k3 stride 2) with
residual blocks, image fusion at stride 8, three transpose-conv decoder
stages with skip concats, 1x1 convs to the descriptor, row-wise L2
normalization. The 20 k3 convs (3 down, 14 in residual blocks, 3 up) run
kernel A; conv1 with occupancy input and the 1x1 convs are plain products.
``dim`` 6 builds the same network over 6-D coordinates (3^6 = 729 offsets
a k3 conv, ``conv1_kernel_size ** 6`` for conv1): Deep Global
Registration's inlier network (``eval.dgr``), with ``with_image=False``.
Every conv is handed its map's exact inverse, so the backward of a training
step is kernel A again (``sparse.ops``); ``train()`` / ``eval()`` choose
batch or running statistics in the norms.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from imfnet_tpu_torch.models.fusion import (AttentionFusion, gather_from_padded,
                                            scatter_to_padded)
from imfnet_tpu_torch.models.layers import SparseBasicBlock, SparseConv, SparseNorm
from imfnet_tpu_torch.models.resnet import ResNetTrunk
from imfnet_tpu_torch.sparse.coords import SparseVoxels, batch_segments, row_mask
from imfnet_tpu_torch.sparse.kernel_map import CoordinatePyramid
from imfnet_tpu_torch.sparse.ops import sparse_cat


class ResUNetIMF(nn.Module):
    """ResUNet2 family; channel plans follow `model/resunet.py:276-326`.

    Submodule names follow the flax module's (``conv1``, ``norm1``,
    ``block1``, ..., ``img_encoder``, ``attention_fusion``, ``final``) so
    ``utils.flax_weights`` maps one tree onto the other."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 32,
        channels: Tuple[int, ...] = (32, 64, 128, 256),
        tr_channels: Tuple[int, ...] = (64, 64, 64, 128),
        norm_type: str = "BN",
        block_norm_type: str = "BN",
        conv1_kernel_size: int = 5,
        normalize_feature: bool = True,
        fusion_depth: int = 0,
        image_channels: int = 128,
        with_image: bool = True,
        compute_dtype: torch.dtype = torch.bfloat16,
        conv1_occupancy: bool = False,
        bn_momentum: float = 0.05,
        dim: int = 3,
    ):
        super().__init__()
        if dim not in (3, 6):
            raise ValueError(f"ResUNetIMF: dim must be 3 or 6, got {dim}")
        ch, tr = channels, tr_channels
        dt = compute_dtype
        k3 = 3 ** dim
        self.dim = dim
        self.in_channels = in_channels
        self.normalize_feature = normalize_feature
        self.with_image = with_image
        self.conv1_occupancy = conv1_occupancy

        def conv(cin, cout, k=k3, bias=False):
            return SparseConv(cin, cout, k, use_bias=bias, compute_dtype=dt)

        def block(c):
            return SparseBasicBlock(c, block_norm_type, dt, bn_momentum, k3)

        def norm(c):
            return SparseNorm(norm_type, c, bn_momentum)

        self.conv1 = conv(in_channels, ch[0], conv1_kernel_size ** dim)
        self.norm1 = norm(ch[0])
        self.block1 = block(ch[0])
        self.conv2 = conv(ch[0], ch[1])
        self.norm2 = norm(ch[1])
        self.block2 = block(ch[1])
        self.conv3 = conv(ch[1], ch[2])
        self.norm3 = norm(ch[2])
        self.block3 = block(ch[2])
        self.conv4 = conv(ch[2], ch[3])
        self.norm4 = norm(ch[3])
        self.block4 = block(ch[3])
        if with_image:
            self.img_encoder = ResNetTrunk(compute_dtype=dt)
            self.attention_fusion = AttentionFusion(
                dim=image_channels, latent_dim=ch[3], depth=fusion_depth,
                cross_heads=1, latent_heads=8, cross_dim_head=ch[3] // 2,
                latent_dim_head=ch[3] // 2, compute_dtype=dt)
        self.conv4_tr = conv(ch[3], tr[3])
        self.norm4_tr = norm(tr[3])
        self.block4_tr = block(tr[3])
        self.conv3_tr = conv(ch[2] + tr[3], tr[2])
        self.norm3_tr = norm(tr[2])
        self.block3_tr = block(tr[2])
        self.conv2_tr = conv(ch[1] + tr[2], tr[1])
        self.norm2_tr = norm(tr[1])
        self.block2_tr = block(tr[1])
        self.conv1_tr = conv(ch[0] + tr[1], tr[0], 1)
        self.final = conv(tr[0], out_channels, 1, bias=True)

    def forward(self, sv: SparseVoxels, pyramid: CoordinatePyramid,
                image: Optional[torch.Tensor]) -> torch.Tensor:
        """Descriptors f32[N0, out_channels]; padding rows are zero.
        ``image`` is [B, H, W, 3] (NHWC) with B the batch count. The
        forward records an autograd graph in ``train()`` and in ``eval()``
        mode alike (an activation map differentiates an eval-mode forward);
        a caller that only infers wraps it in ``torch.no_grad()``."""
        lv = pyramid.levels
        num_batches = image.shape[0] if image is not None else 1
        masks, bids = [], []
        for level in lv:
            m = row_mask(level.coords.shape[0], level.num_valid)
            masks.append(m)
            bids.append(torch.where(m, level.coords[:, 0].long(),
                                    torch.full_like(m, num_batches, dtype=torch.long)))

        def norm(module, x, i):
            return module(x, masks[i], bids[i], num_batches, lv[i].num_valid)

        def block(module, x, i):
            return module(x, lv[i].k3_same, masks[i], bids[i], num_batches,
                          lv[i].num_valid)

        # ---- encoder (model/resunet.py:168-186) ----
        # each conv's nbr_inv: k5_l0 itself, a down map's sibling up map of
        # the level below, an up map's sibling down map of the level above
        out = self.conv1(sv.feats, pyramid.k5_l0,
                         occupancy=self.conv1_occupancy and self.in_channels == 1,
                         nbr_inv=pyramid.k5_l0)
        out_s1 = block(self.block1, norm(self.norm1, out, 0), 0)
        out = self.conv2(out_s1, lv[1].down, nbr_inv=lv[0].up)
        out_s2 = block(self.block2, norm(self.norm2, out, 1), 1)
        out = self.conv3(out_s2, lv[2].down, nbr_inv=lv[1].up)
        out_s4 = block(self.block3, norm(self.norm3, out, 2), 2)
        out = self.conv4(out_s4, lv[3].down, nbr_inv=lv[2].up)
        out = block(self.block4, norm(self.norm4, out, 3), 3)

        # ---- bottleneck fusion (model/resunet.py:189, 237-273) ----
        if self.with_image and image is not None:
            img = self.img_encoder(image)
            b, h, w, c = img.shape
            tokens = img.reshape(b, h * w, c)
            starts, _ = batch_segments(lv[3].coords, masks[3], num_batches)
            safe_b = bids[3].clamp_max(num_batches - 1)
            m_pad = lv[3].coords.shape[0]
            ranks = torch.arange(m_pad, device=out.device) - starts[safe_b]
            padded_q = scatter_to_padded(out, safe_b, ranks, masks[3],
                                         num_batches, m_pad)
            fused = self.attention_fusion(tokens, padded_q)
            out = gather_from_padded(fused, safe_b, ranks, masks[3])

        # ---- decoder (model/resunet.py:191-226) ----
        out = self.conv4_tr(out, lv[2].up, nbr_inv=lv[3].down)
        out = block(self.block4_tr, norm(self.norm4_tr, out, 2), 2)
        out = sparse_cat(out, out_s4)
        out = self.conv3_tr(out, lv[1].up, nbr_inv=lv[2].down)
        out = block(self.block3_tr, norm(self.norm3_tr, out, 1), 1)
        out = sparse_cat(out, out_s2)
        out = self.conv2_tr(out, lv[0].up, nbr_inv=lv[1].down)
        out = block(self.block2_tr, norm(self.norm2_tr, out, 0), 0)
        out = sparse_cat(out, out_s1)
        out = torch.relu(self.conv1_tr(out))
        out = self.final(out, None, masks[0])

        if self.normalize_feature:
            nrm = out.norm(dim=1, keepdim=True)
            out = out / nrm.clamp_min(1e-12) * masks[0][:, None]
        return out
