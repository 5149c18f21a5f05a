"""Nearest-neighbour search: descriptor NN, mutual NN, radius match.

``nn_auto`` is the one entry: kernel B (``match.nn_kernel.flash_nn``) for
CUDA tensors, in the tile and cluster split that ``match.nn_kernel.nn_plan``
gives the call's shape, its plain blocked version for CPU tensors. A query
outside ``query_valid`` gets (0, +inf) and costs the kernel no work.
``queries_valid(mask)`` gives that mask to the calls inside a block that
pass none, for a caller whose call goes through a wrapper that passes on
(queries, refs, ref_valid) alone.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch

from imfnet_tpu_torch.match.nn_kernel import flash_nn, nn_plain

_scope = threading.local()      # .mask: the innermost queries_valid block's


def blocked_nn(queries, refs, ref_valid=None, *, block: int = 4096,
               with_dist: bool = False):
    """argmin_j ||q_i - r_j||² over valid references, the plain blocked
    formula on any device. Returns idx[N] (and d² if ``with_dist``)."""
    idx, d2 = nn_plain(queries, refs, ref_valid, block=block)
    return (idx, d2) if with_dist else idx


@contextlib.contextmanager
def queries_valid(mask: Optional[torch.Tensor]) -> Iterator[None]:
    """``nn_auto``'s ``query_valid`` inside the block, where a call gives
    none (this thread's calls)."""
    outer = getattr(_scope, "mask", None)
    _scope.mask = mask
    try:
        yield
    finally:
        _scope.mask = outer


def nn_auto(queries: torch.Tensor, refs: torch.Tensor,
            ref_valid: Optional[torch.Tensor] = None,
            query_valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32[N], d² f32[N]) nearest valid reference per query; (0,
    +inf) for a query outside ``query_valid`` (bool[N]; without it, the
    enclosing ``queries_valid`` block's mask, else every query)."""
    if query_valid is None:
        query_valid = getattr(_scope, "mask", None)
    return flash_nn(queries.float().contiguous(), refs.float().contiguous(),
                    None if ref_valid is None else ref_valid.contiguous(),
                    None if query_valid is None else query_valid.contiguous())


def find_nn(f0, f1, valid1=None):
    """Descriptor NN (the `find_nn_gpu` contract, `lib/eval.py:18-48`)."""
    return nn_auto(f0, f1, valid1)[0]


def mutual_nn(f0, f1, valid0=None, valid1=None):
    """Mutual-NN filter: (nn01[N0], mutual[N0]) with
    mutual[i] = (nn10[nn01[i]] == i)."""
    nn01 = nn_auto(f0, f1, valid1)[0]
    nn10 = nn_auto(f1, f0, valid0)[0]
    back = nn10[nn01.long()]
    mutual = back == torch.arange(f0.shape[0], dtype=nn01.dtype, device=f0.device)
    if valid0 is not None:
        mutual = mutual & valid0
    return nn01, mutual


def radius_match(xyz0, xyz1, valid0, valid1, radius: float):
    """For each point of xyz0 (already in frame 1), its NN in xyz1 if within
    ``radius``: (idx[N0], ok[N0])."""
    idx, d2 = nn_auto(xyz0, xyz1, valid1)
    ok = valid0 & (d2 <= radius * radius)
    return idx, ok
