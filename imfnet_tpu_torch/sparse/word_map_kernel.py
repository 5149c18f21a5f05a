"""Kernel D: sorted word-table match (``csrc/word_match.cu``) and its plain
PyTorch version.

    t4 int32[*q.shape, 4] = Σ payload[j] over j with wkeys[j] == q      (q < 0: 0)

``wkeys int32[M]`` is sorted and holds each key at most twice (the compact
word table of ``sparse.grid.compact_words``: an anchor entry and a
zero-payload companion); ``payload int32[M, 4]`` is (bits, bits1, rank,
rank1) per entry. A key that is absent gives zeros. Sums wrap in int32, as
both versions add at most one non-zero entry.

Replaces ``imfnet_tpu/sparse/pallas_word_map.py::word_match_planned``. The
TPU kernel keeps the table in VMEM and matches each block of queries against
a planned 128-aligned window by one-hot dots, with a coverage flag for when
a window is too narrow; here every query binary-searches the whole table,
so there is no window, no planner and no flag.
"""
from __future__ import annotations

import ctypes

import torch

from imfnet_tpu_torch.utils import cuda_build


def word_match_plain(wkeys: torch.Tensor, payload: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """Plain version: ``torch.searchsorted`` for the first entry not below
    the query, then the entries at that position and the next, added where
    their key equals the query."""
    m = wkeys.shape[0]
    flat = q.reshape(-1)
    out = torch.zeros((flat.shape[0], 4), dtype=torch.int32, device=q.device)
    if m == 0:
        return out.reshape(*q.shape, 4)
    lo = torch.searchsorted(wkeys, flat)
    for d in (0, 1):
        j = (lo + d).clamp_max(m - 1)
        hit = (flat >= 0) & (lo + d < m) & (wkeys[j] == flat)
        out += torch.where(hit[:, None], payload[j], 0)
    return out.reshape(*q.shape, 4)


def _check(wkeys: torch.Tensor, payload: torch.Tensor, q: torch.Tensor) -> None:
    if wkeys.dim() != 1 or payload.shape != (wkeys.shape[0], 4):
        raise ValueError(f"word_match: want wkeys[M] and payload[M, 4]; got "
                         f"{tuple(wkeys.shape)}, {tuple(payload.shape)}")
    for name, t in (("wkeys", wkeys), ("payload", payload), ("q", q)):
        if t.dtype != torch.int32:
            raise TypeError(f"word_match: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"word_match: {name} must be contiguous")
    if not (wkeys.device == payload.device == q.device):
        raise ValueError("word_match: wkeys, payload and q must share a device")


def word_match(wkeys: torch.Tensor, payload: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """int32[*q.shape, 4]. CUDA tensors launch kernel D (counted in
    ``word_match.launches``); CPU tensors run the plain version."""
    _check(wkeys, payload, q)
    if q.device.type == "cpu":
        return word_match_plain(wkeys, payload, q)
    if q.device.type != "cuda":
        raise ValueError(f"word_match: unsupported device {q.device}")
    out = torch.empty((*q.shape, 4), dtype=torch.int32, device=q.device)
    n = q.numel()
    if n == 0:
        return out
    if payload.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("word_match: payload rows must be 16-byte aligned")
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.word_match(wkeys.data_ptr(), payload.data_ptr(), wkeys.shape[0],
                            q.data_ptr(), n, out.data_ptr(), stream)
    cuda_build.check(rc, "word_match")
    word_match.launches += 1
    return out


word_match.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("word_match")
    fn = lib.word_match
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    return lib
