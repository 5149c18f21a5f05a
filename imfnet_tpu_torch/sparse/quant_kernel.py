"""Kernel C: sorted-run compaction (``csrc/sorted_compact.cu``) and its plain
PyTorch version.

For a key-sorted stream ``(sk, order)``, the ``order`` entry of the first
element of every equal-key run, in stream order, into ``n_out`` slots (-1
beyond), and the run count clamped to ``n_out``. Invalid rows carry
``INVALID_KEY`` (sorted last) and start no run. After a stable sort of the
cell keys this is the first-occurrence voxel dedup of ``quantize_grid``:
each run's first row is its minimum original row, and runs come out in scan
order.

Replaces ``imfnet_tpu/sparse/pallas_quant.py::sorted_compact`` (the JAX
package's ``quantize_grid(compact_impl="pallas")``), with the port's
sentinels: int64 keys with ``INVALID_KEY = 2^63 - 1`` and -1 padding where
the TPU kernel has int32 keys and ``0x7FFFFFFF`` for both.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from imfnet_tpu_torch.sparse.coords import compact_first
from imfnet_tpu_torch.utils import cuda_build, launches

INVALID_KEY = torch.iinfo(torch.int64).max
TILE = 2048   # sorted rows per CUDA block; must equal TILE in the source
SPARES = 4    # zeroed scratches kept ready per size for graphs being captured

# The kernel's state across calls (the ticket counter and one status word a
# tile, ``int64[1 + num_tiles]``) is never reset: each call leaves it ready
# for the next one at the same ``num_tiles`` (``csrc/sorted_compact.cu``),
# provided the calls that share it run one after another. So a scratch is
# owned by (device, stream, num_tiles) for eager calls, which a stream
# orders, and by (device, capture, num_tiles) for the calls recorded into
# one CUDA graph, which the graph orders at every replay, whichever stream
# replays it; two graphs, or a graph and eager calls, never share one and
# may run at the same time. A scratch must start zeroed, and a fill cannot
# be issued while a stream records, so every eager call keeps ``SPARES``
# zeroed ones ready for captures at its size: a call is captured only after
# an eager call at that size (the usual warm-up), else it raises. Scratches
# are a few KB and live as long as the process.
_scratch: Dict[tuple, torch.Tensor] = {}
_spares: Dict[tuple, List[torch.Tensor]] = {}


def _scratch_for(lib: ctypes.CDLL, device: torch.device, stream: int,
                 num_tiles: int) -> torch.Tensor:
    capture = lib.sorted_compact_capture_id(stream)
    if capture < 0:
        raise RuntimeError("sorted_compact: the stream's capture state cannot be read")
    size = (device.index, num_tiles)
    spares = _spares.setdefault(size, [])
    owner = size + (("capture", capture) if capture else ("stream", stream))
    if owner not in _scratch:
        if capture:
            if not spares:
                raise RuntimeError(
                    f"sorted_compact: no zeroed scratch for a captured call of "
                    f"{num_tiles} tiles; call it once outside the capture first")
            _scratch[owner] = spares.pop()
        else:
            _scratch[owner] = _new_scratch(device, num_tiles)
    if not capture:
        while len(spares) < SPARES:
            spares.append(_new_scratch(device, num_tiles))
    return _scratch[owner]


def _new_scratch(device: torch.device, num_tiles: int) -> torch.Tensor:
    return torch.zeros((1 + num_tiles,), dtype=torch.int64, device=device)


def sorted_compact_plain(sk: torch.Tensor, order: torch.Tensor,
                         n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: run-start flags, then ``coords.compact_first``.
    Returns (sel int64[n_out], count int32[])."""
    prev = torch.cat([sk.new_full((1,), -1), sk[:-1]])
    first = (sk != INVALID_KEY) & (sk != prev)
    return compact_first(first, order, n_out)


def _check(sk: torch.Tensor, order: torch.Tensor, n_out: int) -> None:
    if sk.dim() != 1 or order.shape != sk.shape:
        raise ValueError(f"sorted_compact: want sk[n] and order[n]; got "
                         f"{tuple(sk.shape)}, {tuple(order.shape)}")
    if sk.dtype != torch.int64 or order.dtype != torch.int64:
        raise TypeError(f"sorted_compact: sk and order must be int64; got "
                        f"{sk.dtype}, {order.dtype}")
    if n_out < 0:
        raise ValueError(f"sorted_compact: n_out must be >= 0, got {n_out}")
    if sk.device != order.device:
        raise ValueError("sorted_compact: sk and order must share a device")
    if not (sk.is_contiguous() and order.is_contiguous()):
        raise ValueError("sorted_compact: sk and order must be contiguous")


def sorted_compact(sk: torch.Tensor, order: torch.Tensor,
                   n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sel int64[n_out], count int32[]). CUDA tensors launch kernel C (one
    CUDA kernel, counted in ``sorted_compact.launches``); CPU tensors run
    the plain version."""
    _check(sk, order, n_out)
    if sk.device.type == "cpu":
        return sorted_compact_plain(sk, order, n_out)
    if sk.device.type != "cuda":
        raise ValueError(f"sorted_compact: unsupported device {sk.device}")
    n = sk.shape[0]
    sel = torch.empty((n_out,), dtype=torch.int64, device=sk.device)
    count = torch.empty((), dtype=torch.int32, device=sk.device)
    if n == 0:
        sel.fill_(-1)
        count.zero_()
        return sel, count
    num_tiles = -(-n // TILE)
    lib = _library()
    with torch.cuda.device(sk.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _scratch_for(lib, sk.device, stream, num_tiles)
        rc = lib.sorted_compact(sk.data_ptr(), order.data_ptr(), n,
                                scratch.data_ptr(), num_tiles,
                                sel.data_ptr(), n_out, count.data_ptr(), stream)
    cuda_build.check(rc, "sorted_compact")
    launches.count(sorted_compact)
    return sel, count


sorted_compact.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("sorted_compact")
    fn = lib.sorted_compact
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.sorted_compact_capture_id.restype = ctypes.c_longlong
    lib.sorted_compact_capture_id.argtypes = [ctypes.c_void_p]
    return lib
