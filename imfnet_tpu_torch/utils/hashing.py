"""Vectorized coordinate hashing (the `ME.utils.fnv_hash_vec` contract;
``imfnet_tpu.utils.hashing``).

The reference's 3DMatch evaluator maps sampled raw keypoints onto descriptor
rows by intersecting FNV hashes of their voxel keys
(`scripts/evaluation_3dmatch.py:164-171`): the 64-bit FNV-1 column fold
MinkowskiEngine computes, starting at the FNV offset basis, then per column
a multiply by the FNV prime (wrapping at 2^64) and an XOR with the
coordinate cast to uint64 (two's complement for negative ones).
"""
from __future__ import annotations

import numpy as np

_FNV_BASIS = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """uint64[N] row hashes of an integer coordinate array [N, D]."""
    assert arr.ndim == 2
    arr = np.floor(arr).astype(np.int64).astype(np.uint64, copy=False)
    h = np.full(arr.shape[0], _FNV_BASIS, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(arr.shape[1]):
            h = h * _FNV_PRIME
            h = np.bitwise_xor(h, arr[:, j])
    return h


def voxel_key_rows(points: np.ndarray, table_xyz: np.ndarray,
                   voxel_size: float) -> np.ndarray:
    """Rows of ``table_xyz`` whose voxel key matches any of ``points``'
    voxel keys (`evaluation_3dmatch.py:164-171`: isin over fnv-hashed
    floor(·/voxel))."""
    key_pts = fnv_hash_vec(np.floor(points / voxel_size))
    key_tab = fnv_hash_vec(np.floor(table_xyz / voxel_size))
    return np.where(np.isin(key_tab, key_pts))[0]
