"""Sparse-tensor compute ops: gather-GEMM convolution (forward and
backward), masked norms, concat.

A convolution with kernel map ``nbr[N_out,K]`` and weight ``W[K,Cin,Cout]``
is ``out[n] = Σ_k feats[nbr[n,k]] @ W[k]`` with missing neighbours as zero,
computed by kernel A (``sparse.conv_kernel``) on the card. The JAX package's
strategy table (banded one-hot windows, mul-first, z-window gathers) exists
because Mosaic cannot gather and has no counterpart here.

The backward (``imfnet_tpu.sparse.ops._conv_tb_bwd``) has no scatter: the
gradient of the input is kernel A again, through the map's exact inverse
``nbr_inv[N_in,K]`` (a stride-1 map is its own inverse, a down map's is the
sibling up map and the reverse) with offset-flipped, transposed weights,

    dX[m] = Σ_k dY[nbr_inv[m,k]] @ W[K-1-k]ᵀ

and the gradient of the weight is a contraction over output rows,
``dW[k] = gathered(x)[:, k, :]ᵀ @ dY``, a plain product per chunk of offsets.
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
    nbr_inv: Optional[torch.Tensor] = None,   # int32[N_in, K] exact inverse map
) -> torch.Tensor:
    """Sparse convolution → f32[N_out, Cout]. Features and weights are cast
    to ``compute_dtype``; products accumulate in f32. Rows with no valid
    neighbour come out exactly zero; the bias is added only under
    ``out_mask``.

    Differentiable in ``feats``, ``weight`` and ``bias``. The gradient of
    ``feats`` runs through ``nbr_inv``; features that require a gradient
    without it raise, since the only other way is a scatter-add of the
    ``[N, K, Cin]`` gather."""
    if nbr_inv is None and torch.is_grad_enabled() and feats.requires_grad:
        raise ValueError("sparse_conv: feats require a gradient, which needs the "
                         "map's inverse nbr_inv (the map itself for a stride-1 "
                         "conv, the sibling up/down map for a strided one)")
    acc = _SparseConv.apply(feats, weight, nbr.contiguous(),
                            None if nbr_inv is None else nbr_inv.contiguous(),
                            compute_dtype)
    if bias is not None:
        if out_mask is None:
            raise ValueError("sparse_conv: a bias needs out_mask to keep padding zero")
        acc = torch.where(out_mask[:, None], acc + bias.float(),
                          torch.zeros_like(acc))
    return acc


DW_CHUNK_BYTES = 256 << 20   # ceiling of the f32 gather of one dW product


class _SparseConv(torch.autograd.Function):
    """``gather_gemm`` with the scatter-free backward. CUDA tensors run
    kernel A in both directions, CPU tensors its plain version."""

    @staticmethod
    def forward(ctx, feats, weight, nbr, nbr_inv, dt):
        x = feats.to(dt).contiguous()
        w = weight.to(dt).contiguous()
        ctx.save_for_backward(x, w, nbr, nbr_inv)   # in dt: half the bytes in bf16
        ctx.dtypes = (feats.dtype, weight.dtype)
        return gather_gemm(x, nbr, w)

    @staticmethod
    def backward(ctx, dy):
        x, w, nbr, nbr_inv = ctx.saved_tensors
        dyc = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_flip_t = w.flip(0).transpose(1, 2).contiguous()
            dx = gather_gemm(dyc, nbr_inv, w_flip_t).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, nbr, dyc).to(ctx.dtypes[1])
        return dx, dw, None, None, None


def weight_grad(x: torch.Tensor, nbr: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dW[k] = gathered(x)[:, k, :]ᵀ @ dy`` → f32[K, Cin, Cout] (f64 for f64
    operands). Operands are widened before the product, so the products of
    the rounded operands are exact and only the f32 sums round. Offsets are
    taken in chunks whose widened gather stays under ``DW_CHUNK_BYTES``."""
    n_in, cin = x.shape
    n_out, k = nbr.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    x_ext = torch.cat([x, x.new_zeros((1, cin))], dim=0).to(acc)   # widened once
    idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, n_in)).long()
    dyw = dy.to(acc)
    chunk = max(1, min(k, DW_CHUNK_BYTES // max(1, n_out * cin * 4)))
    parts = []
    for k0 in range(0, k, chunk):
        g = x_ext[idx[:, k0:k0 + chunk]]                       # [N, chunk, Cin]
        parts.append((g.reshape(n_out, -1).T @ dyw).reshape(-1, cin, dy.shape[1]))
    return torch.cat(parts, dim=0)


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
