"""Kernel A: the sparse-conv gather-GEMM (``csrc/sparse_conv.cu``) and its
plain PyTorch version.

    out f32[n_out, cout] = Σ_k x[nbr[i, k]] @ W[k]      (nbr = -1 → 0)

Replaces the TPU kernels of ``imfnet_tpu/sparse/pallas_conv.py``
(``banded_conv_pallas_union``, ``banded_conv_pallas_planned`` and their jit
wrapper ``banded_conv_pallas``): one function, so one kernel.
"""
from __future__ import annotations

import ctypes

import torch

from imfnet_tpu_torch.utils import cuda_build

_DTYPES = (torch.bfloat16, torch.float32)


def gather_gemm_plain(x: torch.Tensor, nbr: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Plain version: append a zero row to ``x``, gather [N, K, Cin], one
    product with f32 accumulation (``imfnet_tpu.sparse.ops._flat_apply``).
    bf16 operands are widened to f32 before the product, so each product is
    exact and only the f32 sums round."""
    n_in, cin = x.shape
    n_out, k = nbr.shape
    cout = w.shape[2]
    x_ext = torch.cat([x, x.new_zeros((1, cin))], dim=0)
    idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, n_in)).long()
    g = x_ext[idx].reshape(n_out, k * cin)
    return g.float() @ w.reshape(k * cin, cout).float()


def _check(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 3 or nbr.dim() != 2:
        raise ValueError(f"gather_gemm: want x[N,Cin], nbr[N_out,K], "
                         f"w[K,Cin,Cout]; got {tuple(x.shape)}, "
                         f"{tuple(nbr.shape)}, {tuple(w.shape)}")
    if w.shape[0] != nbr.shape[1] or w.shape[1] != x.shape[1]:
        raise ValueError(f"gather_gemm: shapes disagree: x {tuple(x.shape)}, "
                         f"nbr {tuple(nbr.shape)}, w {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gather_gemm: x and w must share a dtype in "
                        f"{_DTYPES}; got {x.dtype}, {w.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"gather_gemm: nbr must be int32, got {nbr.dtype}")
    if not (x.device == nbr.device == w.device):
        raise ValueError("gather_gemm: x, nbr and w must share a device")
    if not (x.is_contiguous() and nbr.is_contiguous() and w.is_contiguous()):
        raise ValueError("gather_gemm: x, nbr and w must be contiguous")


def gather_gemm(x: torch.Tensor, nbr: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """f32[n_out, cout]. CUDA tensors launch kernel A (and count the launch
    in ``gather_gemm.launches``); CPU tensors run the plain version."""
    _check(x, nbr, w)
    if x.device.type == "cpu":
        return gather_gemm_plain(x, nbr, w)
    if x.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {x.device}")
    n_out, k = nbr.shape
    cin, cout = w.shape[1], w.shape[2]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=x.device)
    if n_out == 0 or cout == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sparse_conv_gather_gemm(
            x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
            n_out, k, cin, cout, int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(rc, "sparse_conv_gather_gemm")
    gather_gemm.launches += 1
    return out


gather_gemm.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("sparse_conv")
    fn = lib.sparse_conv_gather_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib
