"""Sparse-voxel network modules: conv layers, masked norms, residual block.

In ``eval()`` mode the norms use their running statistics; in ``train()``
mode a batch norm normalizes with the statistics of the batch's valid rows
and updates its running buffers in place. Parameters are f32;
``compute_dtype`` sets the operand type of the products, which accumulate in
f32.
"""
from __future__ import annotations

import torch
from torch import nn

from imfnet_tpu_torch.sparse.ops import (masked_batchnorm_stats, masked_instancenorm,
                                         sparse_conv)


def dot_f32(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``dtype`` and an f32 result: the
    products of the rounded operands are exact in f32 and only the f32 sums
    round (``jnp.dot(..., preferred_element_type=float32)``)."""
    return a.to(dtype).float() @ b.to(dtype).float()


class SparseConv(nn.Module):
    """Sparse convolution over a precomputed kernel map, weight
    ``[K, Cin, Cout]``; ``kernel_volume=1`` is a 1x1x1 conv with weight
    ``[Cin, Cout]``, a plain product on the features."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 27, use_bias: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_channels = in_channels
        self.compute_dtype = compute_dtype
        shape = ((in_channels, out_channels) if kernel_volume == 1
                 else (kernel_volume, in_channels, out_channels))
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None
        # variance scaling over fan_in = K * Cin, as the flax initializer
        std = (kernel_volume * in_channels) ** -0.5
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)

    def forward(self, feats, nbr=None, out_mask=None, occupancy=False,
                nbr_inv=None):
        """``nbr_inv`` is the map's exact inverse, which the gradient of
        ``feats`` runs through (``sparse.ops.sparse_conv``)."""
        dt = self.compute_dtype
        if occupancy and self.in_channels == 1:
            # occupancy-1 inputs: conv = (neighbour exists) @ W[:, 0, :]
            return dot_f32((nbr >= 0).to(dt), self.weight[:, 0, :], dt)
        if nbr is None:
            out = dot_f32(feats, self.weight, dt)
            if self.bias is not None:
                if out_mask is None:
                    raise ValueError("a bias needs out_mask to keep padding zero")
                out = torch.where(out_mask[:, None], out + self.bias,
                                  torch.zeros_like(out))
            return out
        return sparse_conv(feats, nbr, self.weight, bias=self.bias,
                           out_mask=out_mask, compute_dtype=dt, nbr_inv=nbr_inv)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid sparse rows (`ME.MinkowskiBatchNorm`), eps 1e-5.
    Training mode takes the batch's mean and biased variance over the valid
    rows and moves the running buffers towards the mean and the unbiased
    variance, torch-style: running = (1 - m) * running + m * batch."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.05):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, feats, mask, num_valid=None):
        if self.training:
            if num_valid is None:
                num_valid = mask.sum()
            mean, var = masked_batchnorm_stats(feats, mask, num_valid)
            with torch.no_grad():
                m = self.momentum
                n = num_valid.float().clamp_min(2.0)
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * n / (n - 1.0)))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = (feats.float() - mean) * inv + self.bias
        return out * mask[:, None]


class SparseNorm(nn.Module):
    """Norm factory: 'BN' (masked batch norm) or 'IN' (per-sample)."""

    def __init__(self, norm_type: str, features: int, momentum: float = 0.05):
        super().__init__()
        if norm_type not in ("BN", "IN"):
            raise ValueError(f"norm type {norm_type} not defined")
        self.bn = (MaskedBatchNorm(features, momentum=momentum)
                   if norm_type == "BN" else None)

    def forward(self, feats, mask, batch_ids, max_batch, num_valid=None):
        if self.bn is not None:
            return self.bn(feats, mask, num_valid)
        return masked_instancenorm(feats, batch_ids, mask, max_batch)


class SparseBasicBlock(nn.Module):
    """Residual block: 2x(k3 conv + norm), identity skip, ReLU
    (`model/residual_block.py:37-53`)."""

    def __init__(self, channels: int, norm_type: str = "BN",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bn_momentum: float = 0.05, kernel_volume: int = 27):
        super().__init__()
        self.conv0 = SparseConv(channels, channels, kernel_volume,
                                compute_dtype=compute_dtype)
        self.norm0 = SparseNorm(norm_type, channels, bn_momentum)
        self.conv1 = SparseConv(channels, channels, kernel_volume,
                                compute_dtype=compute_dtype)
        self.norm1 = SparseNorm(norm_type, channels, bn_momentum)

    def forward(self, feats, nbr, mask, batch_ids, max_batch, num_valid=None):
        # a stride-1 map is its own exact inverse (up to the offset flip the
        # conv backward applies)
        out = self.conv0(feats, nbr, nbr_inv=nbr)
        out = torch.relu(self.norm0(out, mask, batch_ids, max_batch, num_valid))
        out = self.conv1(out, nbr, nbr_inv=nbr)
        out = self.norm1(out, mask, batch_ids, max_batch, num_valid)
        return torch.relu(out + feats)
