"""Attention fusion at the UNet bottleneck (reference
`model/attention_fusion.py`): one PreNorm cross-attention block (queries =
bottleneck point features, context = image tokens) with a GEGLU feed-forward,
then ``depth`` self-attention layers (0 in IMFNet).

The flat sparse rows are scattered into a padded [B, M, C] tensor, one
batched dense attention runs, and the result is gathered back. Linear layers
run in ``compute_dtype`` (output too, like flax ``nn.Dense(dtype=...)``); the
score and value products accumulate in f32; LayerNorm eps is 1e-6 as in flax.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imfnet_tpu_torch.models.layers import dot_f32

LAYERNORM_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class CrossAttention(nn.Module):
    """Queries [B,M,Dq] attend to context [B,T,Dc]."""

    def __init__(self, query_dim: int, context_dim: int, heads: int = 1,
                 dim_head: int = 128, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.compute_dtype = compute_dtype
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context):
        dt = self.compute_dtype
        h, d = self.heads, self.dim_head
        q = _linear(self.to_q, x, dt)
        k, v = _linear(self.to_kv, context, dt).chunk(2, dim=-1)

        def split_heads(t):  # [B,N,h*d] -> [B,h,N,d]
            b, n, _ = t.shape
            return t.reshape(b, n, h, d).transpose(1, 2)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        sim = dot_f32(q, k.transpose(-1, -2), dt) * (d ** -0.5)
        attn = torch.softmax(sim, dim=-1)
        out = dot_f32(attn, v, dt)
        b, _, m, _ = out.shape
        out = out.transpose(1, 2).reshape(b, m, h * d)
        return F.linear(out, self.to_out.weight, self.to_out.bias)


class GEGLUFeedForward(nn.Module):
    """Linear(dim→2·mult·dim) → x·gelu(gates) → Linear(mult·dim→dim)."""

    def __init__(self, dim: int, mult: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.wi = nn.Linear(dim, dim * mult * 2)
        self.wo = nn.Linear(dim * mult, dim)

    def forward(self, x):
        x1, gates = _linear(self.wi, x, self.compute_dtype).chunk(2, dim=-1)
        hidden = x1 * F.gelu(gates)   # exact erf
        return F.linear(hidden.float(), self.wo.weight, self.wo.bias)


class AttentionFusion(nn.Module):
    """PreNorm cross-attn + residual, PreNorm GEGLU FF + residual, then
    ``depth`` PreNorm self-attention + FF layers."""

    def __init__(self, dim: int = 128, latent_dim: int = 256, depth: int = 0,
                 cross_heads: int = 1, latent_heads: int = 8,
                 cross_dim_head: int = 128, latent_dim_head: int = 128,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depth = depth
        ln = lambda n: nn.LayerNorm(n, eps=LAYERNORM_EPS)  # noqa: E731
        self.cross_norm_q = ln(latent_dim)
        self.cross_norm_ctx = ln(dim)
        self.cross_attn = CrossAttention(latent_dim, dim, cross_heads,
                                         cross_dim_head, compute_dtype)
        self.cross_ff_norm = ln(latent_dim)
        self.cross_ff = GEGLUFeedForward(latent_dim, 4, compute_dtype)
        for i in range(depth):
            self.add_module(f"self_norm_{i}", ln(latent_dim))
            self.add_module(f"self_attn_{i}", CrossAttention(
                latent_dim, latent_dim, latent_heads, latent_dim_head,
                compute_dtype))
            self.add_module(f"self_ff_norm_{i}", ln(latent_dim))
            self.add_module(f"self_ff_{i}", GEGLUFeedForward(latent_dim, 4,
                                                             compute_dtype))

    def forward(self, context, queries):
        """context [B,T,dim], queries [B,M,latent_dim] → [B,M,latent_dim]."""
        x = self.cross_attn(self.cross_norm_q(queries),
                            self.cross_norm_ctx(context)) + queries
        x = self.cross_ff(self.cross_ff_norm(x)) + x
        for i in range(self.depth):
            xn = getattr(self, f"self_norm_{i}")(x)
            x = getattr(self, f"self_attn_{i}")(xn, xn) + x
            x = getattr(self, f"self_ff_{i}")(getattr(self, f"self_ff_norm_{i}")(x)) + x
        return x


def scatter_to_padded(feats, batch_ids, ranks, valid, num_batches: int,
                      m_pad: int):
    """Flat sparse rows [N,C] → padded [B, m_pad, C] by (batch, rank)."""
    n, c = feats.shape
    drop = num_batches * m_pad
    flat_idx = torch.where(valid & (ranks < m_pad), batch_ids * m_pad + ranks,
                           torch.full_like(ranks, drop))
    out = feats.new_zeros((drop + 1, c))
    out[flat_idx.long()] = feats
    return out[:-1].reshape(num_batches, m_pad, c)


def gather_from_padded(padded, batch_ids, ranks, valid):
    """Inverse of scatter_to_padded: padded [B,m_pad,C] → flat [N,C]."""
    b, m_pad, c = padded.shape
    flat = padded.reshape(b * m_pad, c)
    idx = (batch_ids * m_pad + ranks).clamp(0, b * m_pad - 1).long()
    return flat[idx] * valid[:, None]
