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
a window is too narrow; here every query is searched for in all of the
table's entries in use, so there is no window, no planner and no flag.

``word_match_many`` is the kernel's entry: one launch for up to 16 problems
(a pyramid's ten maps); a warp takes 32 consecutive rows of one (dx) group
of a map's dy columns, one lane a row, brackets its keys in the table by a
search of the whole warp, and each lane searches the bracket for its keys in
step. ``word_match`` is its one-problem case.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

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
    if wkeys.shape[0] > MAX_TABLE:
        raise ValueError(f"word_match: the table holds at most {MAX_TABLE} entries")
    if not (wkeys.device == payload.device == q.device):
        raise ValueError("word_match: wkeys, payload and q must share a device")


MAX_PROBLEMS = 16   # problems of one launch (the kernel's parameter table)
MAX_TABLE = (1 << 31) - 1  # entries of a table (the kernel's positions are int32)

# (wkeys int32[M], payload int32[M, 4], n_words int32[] or None, q int32[...])
Problem = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def query_group(shape: Sequence[int]) -> int:
    """The kernel's layout of a query tensor: rows of ``group²`` queries, of
    which one lane serves ``group`` consecutive ones. Where the last axis is
    the 9 or 25 columns of a kernel map (dx slowest,
    ``sparse.grid.word_queries``), a row is a map row and a group its 3 or
    5 dy columns of one dx; else every query is a row of its own (1). Any
    layout is exact; this one makes a warp's keys neighbours in the table."""
    if len(shape) >= 2 and shape[-1] in (9, 25):
        return math.isqrt(shape[-1])
    return 1


def word_match(wkeys: torch.Tensor, payload: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """int32[*q.shape, 4]: ``word_match_many`` for one problem that uses the
    whole table."""
    return word_match_many([(wkeys, payload, None, q)])[0]


def word_match_many(problems: Sequence[Problem]) -> List[torch.Tensor]:
    """[int32[*q.shape, 4]] for every ``(wkeys, payload, n_words, q)``.

    ``n_words`` is a device int32 scalar, the table's entries in use (the
    rest must match no query with a non-zero payload, as ``compact_words``'
    padding does), or None for the whole table; it is never read on the
    host. CUDA tensors launch kernel D once for every ``MAX_PROBLEMS``
    problems (each launch counted in ``word_match_many.launches``); CPU
    tensors run the plain version per problem."""
    problems = list(problems)
    for wkeys, payload, n_words, q in problems:
        _check(wkeys, payload, q)
        if n_words is not None and (n_words.dtype != torch.int32 or n_words.dim() != 0
                                    or n_words.device != q.device):
            raise ValueError("word_match: n_words must be an int32 scalar on q's device")
    if not problems:
        return []
    device = problems[0][3].device
    if any(q.device != device for *_, q in problems):
        raise ValueError("word_match: all problems must share a device")
    if device.type == "cpu":
        return [word_match_plain(wkeys, payload, q) for wkeys, payload, _, q in problems]
    if device.type != "cuda":
        raise ValueError(f"word_match: unsupported device {device}")
    outs = [torch.empty((*q.shape, 4), dtype=torch.int32, device=device)
            for *_, q in problems]
    live = [(pr, out) for pr, out in zip(problems, outs) if out.numel()]
    for (_, payload, _, _), out in live:
        if payload.data_ptr() % 16 or out.data_ptr() % 16:
            raise ValueError("word_match: payload rows must be 16-byte aligned")
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, len(live), MAX_PROBLEMS):
            chunk = live[i:i + MAX_PROBLEMS]
            table = (_WordProblem * len(chunk))(*[
                _WordProblem(wkeys.data_ptr(), payload.data_ptr(),
                             None if n_words is None else n_words.data_ptr(),
                             q.data_ptr(), out.data_ptr(), q.numel() // group ** 2,
                             wkeys.shape[0], group)
                for (wkeys, payload, n_words, q), out in chunk
                for group in [query_group(q.shape)]])
            rc = lib.word_match_many(table, len(chunk), stream)
            cuda_build.check(rc, "word_match_many")
            word_match_many.launches += 1
    return outs


word_match_many.launches = 0


def empty_launch() -> None:
    """Launch an empty kernel on the current stream: what a launch costs
    before any work, for ``chip_smoke.py``'s ``launch_floor_ms``."""
    cuda_build.check(_library().empty_launch(torch.cuda.current_stream().cuda_stream),
                     "empty_launch")


class _WordProblem(ctypes.Structure):
    """``WordProblem`` of ``csrc/word_match.cu``."""
    _fields_ = [("keys", ctypes.c_void_p), ("payload", ctypes.c_void_p),
                ("n_words", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("m", ctypes.c_int), ("group", ctypes.c_int)]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("word_match")
    lib.word_match_many.restype = ctypes.c_int
    lib.word_match_many.argtypes = [ctypes.POINTER(_WordProblem), ctypes.c_int,
                                    ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    return lib
