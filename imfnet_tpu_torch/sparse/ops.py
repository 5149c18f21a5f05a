"""Sparse-tensor compute ops: gather-GEMM convolution (forward), masked
norms, concat.

A convolution with kernel map ``nbr[N_out,K]`` and weight ``W[K,Cin,Cout]``
is ``out[n] = Σ_k feats[nbr[n,k]] @ W[k]`` with missing neighbours as zero,
computed by kernel A (``sparse.conv_kernel``) on the card. The JAX package's
strategy table (banded one-hot windows, mul-first, z-window gathers) exists
because Mosaic cannot gather and has no counterpart here. The custom-VJP
backward belongs to the training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from imfnet_tpu_torch.sparse.conv_kernel import gather_gemm
from imfnet_tpu_torch.sparse.coords import row_mask

__all__ = ["sparse_conv", "masked_batchnorm_stats", "masked_instancenorm",
           "sparse_cat", "row_mask"]


def sparse_conv(
    feats: torch.Tensor,      # [N_in, Cin]
    nbr: torch.Tensor,        # int32[N_out, K], -1 = none
    weight: torch.Tensor,     # [K, Cin, Cout]
    *,
    bias: Optional[torch.Tensor] = None,      # [Cout]
    out_mask: Optional[torch.Tensor] = None,  # bool[N_out]; required with bias
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Sparse convolution → f32[N_out, Cout]. Features and weights are cast
    to ``compute_dtype``; products accumulate in f32. Rows with no valid
    neighbour come out exactly zero; the bias is added only under
    ``out_mask``."""
    x = feats.to(compute_dtype).contiguous()
    w = weight.to(compute_dtype).contiguous()
    acc = gather_gemm(x, nbr.contiguous(), w)
    if bias is not None:
        if out_mask is None:
            raise ValueError("sparse_conv: a bias needs out_mask to keep padding zero")
        acc = torch.where(out_mask[:, None], acc + bias.float(),
                          torch.zeros_like(acc))
    return acc


def masked_batchnorm_stats(
    feats: torch.Tensor, mask: torch.Tensor, num_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var) over valid rows only."""
    denom = num_valid.float().clamp_min(1.0)
    f = feats.float() * mask[:, None]
    mean = f.sum(dim=0) / denom
    sq = (f * f).sum(dim=0) / denom
    var = (sq - mean * mean).clamp_min(0.0)
    return mean, var


def masked_instancenorm(
    feats: torch.Tensor,
    batch_ids: torch.Tensor,   # int[N] batch index per row (padding → max_batch)
    mask: torch.Tensor,
    max_batch: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Per-sample (per batch segment) feature normalization
    (`ME.MinkowskiInstanceNorm`)."""
    b = torch.where(mask, batch_ids.long(), torch.full_like(batch_ids, max_batch).long())
    f = feats.float() * mask[:, None]
    c = f.shape[1]
    cnt = torch.zeros((max_batch + 1, 1), device=f.device).index_add_(
        0, b, torch.ones_like(f[:, :1]))
    s = torch.zeros((max_batch + 1, c), device=f.device).index_add_(0, b, f)
    mean = s / cnt.clamp_min(1.0)
    centered = f - mean[b] * mask[:, None]
    sq = torch.zeros((max_batch + 1, c), device=f.device).index_add_(
        0, b, centered * centered)
    var = sq / cnt.clamp_min(1.0)
    return centered * torch.rsqrt(var[b] + eps) * mask[:, None]


def sparse_cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Feature concat of two sparse tensors sharing a coordinate table."""
    return torch.cat([a, b], dim=1)
