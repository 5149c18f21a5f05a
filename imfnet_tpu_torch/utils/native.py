"""ctypes bindings of the native host library (``native/host_ops.cpp``;
``imfnet_tpu.utils.native``), with numpy/scipy fallbacks.

The first call runs ``make -C native``, which builds
``native/libimfnet_host.so`` from the sources in the repository (a no-op
when it is current), and loads it. Without a toolchain, or when the build
fails, every function falls back to the JAX package's numpy or scipy
version; ``have_native()`` says which one runs. Host code, not a kernel:
the voxel dedup of the loaders (the reference's `ME.utils.sparse_quantize`,
`lib/data_loaders.py:291`) and the overlap tool's radius counts.

The two versions of ``voxel_dedup`` differ in one operation: the library
computes cells as ``floor(x * (1/voxel))`` in f32, the fallback as
``floor(x / voxel)``, so a point that lies on a cell boundary can fall on
either side.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libimfnet_host.so")
# serializes the build between processes (test workers start together)
_LOCK_PATH = os.path.join(_REPO, "imfnet_tpu_torch", "_build", "native.lock")
_lib: Optional[ctypes.CDLL] = None
_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _build() -> None:
    os.makedirs(os.path.dirname(_LOCK_PATH), exist_ok=True)
    with open(_LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # make always: a no-op when the .so is current, a rebuild when
        # host_ops.cpp is newer (a stale .so would miss newer symbols)
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                       capture_output=True, timeout=120)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        _build()
    except Exception:
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.voxel_dedup.restype = ctypes.c_int64
    lib.voxel_dedup.argtypes = [_F32P, ctypes.c_int64, ctypes.c_float, _I32P, _I32P,
                                ctypes.c_int64]
    for fn in (lib.count_within_radius, lib.count_pairs_within_radius):
        fn.restype = ctypes.c_int64
        fn.argtypes = [_F32P, ctypes.c_int64, _F32P, ctypes.c_int64, ctypes.c_float]
    _lib = lib
    return _lib


def have_native() -> bool:
    """Whether the native library built and loaded in this process."""
    return _load() is not None


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def voxel_dedup(xyz: np.ndarray, voxel_size: float,
                max_out: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(coords int32[k,3], sel int32[k]): first-occurrence voxel dedup,
    rows in input order; the native hash table, else numpy's sort-unique."""
    lib = _load()
    n = len(xyz)
    if max_out is None:
        max_out = n
    if lib is not None and n > 0:
        x = _f32(xyz)
        sel = np.empty(max_out, np.int32)
        coords = np.empty((max_out, 3), np.int32)
        k = lib.voxel_dedup(x.ctypes.data_as(_F32P), n, ctypes.c_float(voxel_size),
                            sel.ctypes.data_as(_I32P), coords.ctypes.data_as(_I32P), max_out)
        order = np.argsort(sel[:k], kind="stable")
        return coords[:k][order], sel[:k][order]
    v = np.floor(xyz / voxel_size).astype(np.int32)
    _, sel = np.unique(v, axis=0, return_index=True)
    sel = np.sort(sel)
    return v[sel], sel.astype(np.int32)


def count_within_radius(src: np.ndarray, dst: np.ndarray, radius: float) -> int:
    """Number of src points with a dst point within ``radius``."""
    lib = _load()
    if lib is not None:
        s, d = _f32(src), _f32(dst)
        return int(lib.count_within_radius(s.ctypes.data_as(_F32P), len(s),
                                           d.ctypes.data_as(_F32P), len(d),
                                           ctypes.c_float(radius)))
    from scipy.spatial import cKDTree

    dd, _ = cKDTree(dst).query(src, k=1)
    return int((dd <= radius).sum())


def count_pairs_within_radius(src: np.ndarray, dst: np.ndarray, radius: float) -> int:
    """Total (i, j) pairs with |src_i - dst_j| <= radius: the statistic
    `len(get_matching_indices(...))` measures (`util/pointcloud.py:56-69`),
    used by the KITTI <1000-match pair rejection
    (`lib/data_loaders.py:586-588`)."""
    if len(src) == 0 or len(dst) == 0:
        return 0
    lib = _load()
    if lib is not None:
        s, d = _f32(src), _f32(dst)
        return int(lib.count_pairs_within_radius(s.ctypes.data_as(_F32P), len(s),
                                                 d.ctypes.data_as(_F32P), len(d),
                                                 ctypes.c_float(radius)))
    from scipy.spatial import cKDTree

    tree = cKDTree(dst)
    return int(np.sum(tree.query_ball_point(src, radius, return_length=True)))
