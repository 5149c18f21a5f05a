"""Kernel B: flash nearest-neighbour search (``csrc/flash_nn.cu``) and its
plain PyTorch version.

For each query, the nearest valid reference and the squared distance
``max(|q|² + |r|² − 2 q·r, 0)``; invalid references are never chosen, ties go
to the lowest index, and with no valid reference the result is (0, +inf).
Replaces ``imfnet_tpu/match/pallas_nn.py::nn_pallas``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from imfnet_tpu_torch.utils import cuda_build

KERNEL_DIMS = (3, 32)


def nn_plain(queries: torch.Tensor, refs: torch.Tensor,
             ref_valid: Optional[torch.Tensor] = None, *,
             block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the ``imfnet_tpu.match.nn.blocked_nn`` formula: per
    block of references, d² = |q|² + |r|² − 2 q·r, argmin within the block,
    strict ``<`` across blocks. Returns (idx int32[N], d2 f32[N])."""
    q = queries.float()
    r = refs.float()
    n, m = q.shape[0], r.shape[0]
    q_sq = (q * q).sum(dim=1, keepdim=True)
    best_d = torch.full((n,), float("inf"), device=q.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=q.device)
    for off in range(0, m, block):
        rb = r[off:off + block]
        d2 = q_sq + (rb * rb).sum(dim=1)[None, :] - 2.0 * (q @ rb.T)
        if ref_valid is not None:
            d2 = torch.where(ref_valid[None, off:off + block], d2,
                             torch.full_like(d2, float("inf")))
        loc_d, loc = d2.min(dim=1)
        better = loc_d < best_d
        best_d = torch.where(better, loc_d, best_d)
        best_i = torch.where(better, (loc + off).to(torch.int32), best_i)
    return best_i, best_d.clamp_min(0.0)


def _check(q: torch.Tensor, r: torch.Tensor, valid: Optional[torch.Tensor]) -> None:
    if q.dim() != 2 or r.dim() != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"flash_nn: want q[N,D], r[M,D]; got "
                         f"{tuple(q.shape)}, {tuple(r.shape)}")
    if q.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"flash_nn: q and r must be float32; got {q.dtype}, {r.dtype}")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (r.shape[0],)):
        raise ValueError("flash_nn: ref_valid must be bool[M]")
    devices = {q.device, r.device} | ({valid.device} if valid is not None else set())
    if len(devices) != 1:
        raise ValueError("flash_nn: q, r and ref_valid must share a device")
    for t in (q, r, valid):
        if t is not None and not t.is_contiguous():
            raise ValueError("flash_nn: inputs must be contiguous")


def flash_nn(queries: torch.Tensor, refs: torch.Tensor,
             ref_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32[N], d2 f32[N]). CUDA tensors launch kernel B (D must be 3
    or 32; the launch is counted in ``flash_nn.launches``); CPU tensors run
    the plain version."""
    _check(queries, refs, ref_valid)
    if queries.device.type == "cpu":
        return nn_plain(queries, refs, ref_valid)
    if queries.device.type != "cuda":
        raise ValueError(f"flash_nn: unsupported device {queries.device}")
    n, d = queries.shape
    m = refs.shape[0]
    if d not in KERNEL_DIMS:
        raise ValueError(f"flash_nn: the kernel serves D in {KERNEL_DIMS}, got {d}")
    out_i = torch.empty((n,), dtype=torch.int32, device=queries.device)
    out_d = torch.empty((n,), dtype=torch.float32, device=queries.device)
    if n == 0:
        return out_i, out_d
    lib = _library()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_nn(
            queries.data_ptr(), refs.data_ptr(),
            None if ref_valid is None else ref_valid.data_ptr(),
            out_i.data_ptr(), out_d.data_ptr(), n, m, d, stream)
    cuda_build.check(rc, "flash_nn")
    flash_nn.launches += 1
    return out_i, out_d


flash_nn.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_nn")
    lib.flash_nn.restype = ctypes.c_int
    lib.flash_nn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib
