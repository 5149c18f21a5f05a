"""ResNet image trunk: ResNet-34 truncated after layer2 (reference
`model/resnet.py:195-216`), 128 channels at 1/8 resolution.

Takes and returns NHWC (the JAX package's layout) and runs NCHW inside.
Convolutions run in ``compute_dtype`` (their output too, like flax
``nn.Conv(dtype=...)``); batch norms run in f32, on running statistics in
``eval()`` mode and on the batch's in ``train()`` mode.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor, training: bool) -> torch.Tensor:
    """Batch norm in f32. In training the running buffers move by
    ``bn.momentum`` (0.1, flax's ``momentum=0.9``) towards the batch mean and
    the *biased* batch variance, as flax ``nn.BatchNorm`` stores them;
    ``nn.BatchNorm2d`` would store the unbiased one, so the update is made
    here and ``F.batch_norm`` only normalizes."""
    x = x.float()
    if not training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, training=False, momentum=0.0, eps=bn.eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        m = bn.momentum
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * var)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, training=True,
                        momentum=0.0, eps=bn.eps)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


class BasicBlock2D(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        if downsample:
            self.down_conv = nn.Conv2d(in_planes, planes, 1, stride, 0, bias=False)
            self.down_bn = nn.BatchNorm2d(planes, eps=1e-5)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x):
        dt = self.compute_dtype
        tr = self.training
        out = torch.relu(_bn(self.bn1, _conv(self.conv1, x, dt), tr))
        out = _bn(self.bn2, _conv(self.conv2, out, dt), tr)
        identity = x
        if self.down_conv is not None:
            identity = _bn(self.down_bn, _conv(self.down_conv, x, dt), tr)
        return torch.relu(out + identity.float())


class ResNetTrunk(nn.Module):
    """conv1 → maxpool → layer1 → layer2; ``stage_sizes=(3, 4)`` is
    ResNet-34's layer1/layer2. Blocks are named ``layer{i}_block{j}``."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4),
                 widths: Sequence[int] = (64, 128),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.block_names = []
        in_planes = 64
        for i, (n_blocks, width) in enumerate(zip(stage_sizes, widths)):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                downsample = j == 0 and (i > 0 or width != 64)
                name = f"layer{i + 1}_block{j}"
                self.add_module(name, BasicBlock2D(in_planes, width, stride,
                                                   downsample, compute_dtype))
                self.block_names.append(name)
                in_planes = width

    def forward(self, x):
        """x: [B, H, W, 3] in [0, 1] → [B, H/8, W/8, widths[-1]] f32."""
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(_bn(self.bn1, _conv(self.conv1, x, dt), self.training))
        x = F.max_pool2d(x, 3, 2, 1).to(dt)   # pads with -inf
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1).float()
