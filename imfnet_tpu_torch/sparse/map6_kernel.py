"""Kernel E: the 6-D kernel-map builder (``csrc/map6.cu``) and a plain
PyTorch emulation of its hash.

For each problem ``(out_table, in_table, deltas, scale)`` of ``map6_many``:

    nbr int32[N_out, K][i, c] = the least row j of the input table with
        keys[in][j] == keys[out][i] + scale * deltas[c], else -1

``keys`` are one int64 tensor a table (``sparse.coords.make_keys``); a key at
or above ``PAD_QUERY_KEY`` is a sentinel (a padding row, a row out of the
key's range): a sentinel row of the output gives -1s and probes nothing, a
sentinel row of the input is never found. ``deltas`` are the offsets' key
deltas at scale 1 (``sparse.kernel_map.key_deltas``). It is
``sparse.kernel_map.offset_map6_plain``'s chunked ``searchsorted`` chain
computed another way, and equal to it entry for entry; that chain stays the
CPU's version of a 6-D map and the oracle of the tests.

The kernel hashes each input table once, open-addressed: a bucket is one
32-byte sector of ``SLOTS`` int64 keys (their rows in a second array), a
key's home bucket Fibonacci hashing of its prefix (the key without its last
two axes' fields, ``key >> DROP_BITS``), linear probing over buckets, at
least four slots a table row (``hash_buckets``). A lookup reads buckets from
the home to the first one that is not full. Then one launch writes every
map: a thread a group of 9 columns of a row, which share a prefix in the
k3 offsets' product order and so one home bucket; tiles of 16 rows staged
in shared memory, written with 16-byte streaming stores.
``hash_plain`` and ``lookup_plain`` are that hash in plain PyTorch (the same
function, slot layout and probe order), the emulation the CPU tests hold to
the ``searchsorted`` chain; ``map6_many`` runs it for CPU tensors.

Each call tallies on the card the entries it probed (``map6.queries``) and
the buckets they read (``map6.probes``), ``utils.timer.count_device``:
probes over queries is 1 when every lookup ends in its home bucket.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from imfnet_tpu_torch.sparse.coords import PAD_QUERY_KEY
from imfnet_tpu_torch.utils import cuda_build, launches, timer

SLOTS = 4                 # keys a bucket: one 32-byte sector
DROP_BITS = 20            # the last two axes' fields, left out of the home's prefix
GOLDEN = 0x9E3779B97F4A7C15   # Fibonacci hashing's multiplier (2^64 / the golden ratio)
MAX_TABLES = 8            # tables of one call (the kernel's parameter table)
MAX_PROBLEMS = 16         # maps of one call
MAX_LOG2_BUCKETS = 28
_PREFIX_MASK = (1 << (64 - DROP_BITS)) - 1
_GOLDEN_I64 = GOLDEN - (1 << 64)       # the same 64 bits as a signed int64

# (out table, in table, deltas int64[K], scale)
Problem = Tuple[int, int, torch.Tensor, int]


def hash_buckets(rows: int) -> int:
    """Buckets of a table of ``rows`` rows: the least power of two, at
    least 2, whose ``SLOTS`` slots a bucket hold four slots a row (a load
    of at most 0.25, whatever the table's valid count)."""
    return max(2, 1 << (max(int(rows), 1) - 1).bit_length())


def scratch_bytes(rows: Sequence[int]) -> int:
    """Bytes of one call's scratch, for the searched tables of ``rows``
    rows: each one's keys (8 bytes a slot) and rows (4 bytes a slot), in
    the tables' order."""
    return sum(hash_buckets(n) * SLOTS * 12 for n in rows)


def home_bucket(keys: torch.Tensor, buckets: int) -> torch.Tensor:
    """int64: the home bucket of each int64 key: the top log2(buckets) bits
    of ``(key >> DROP_BITS) * GOLDEN`` mod 2^64, the shifts logical."""
    log2 = buckets.bit_length() - 1
    prefix = (keys >> DROP_BITS) & _PREFIX_MASK
    return ((prefix * _GOLDEN_I64) >> (64 - log2)) & (buckets - 1)


def hash_plain(keys: torch.Tensor, buckets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hkeys int64[buckets * SLOTS], hrows int64[buckets * SLOTS]) of one
    table: each key below ``PAD_QUERY_KEY`` once, with its least row, at
    the first free slot of the first bucket from its home on that is not
    full; -1 in a free slot. Keys go in by least row, a round at a time:
    each pending key takes its bucket's next free slot, in row order, or
    moves on to the next bucket. Any order fills the same slots (linear
    probing's occupied cells do not depend on it); the kernel's racing
    inserts may put two keys of one chain in each other's place."""
    hkeys = torch.full((buckets * SLOTS,), -1, dtype=torch.int64, device=keys.device)
    hrows = torch.full_like(hkeys, -1)
    rows = torch.nonzero(keys < PAD_QUERY_KEY).flatten()
    if rows.numel() == 0:
        return hkeys, hrows
    uniq, inv = torch.unique(keys[rows], return_inverse=True)
    least = torch.full((len(uniq),), keys.shape[0], dtype=torch.int64, device=keys.device)
    least.scatter_reduce_(0, inv, rows, reduce="amin")
    order = torch.argsort(least)
    uniq, least = uniq[order], least[order]
    fill = torch.zeros(buckets, dtype=torch.int64, device=keys.device)
    bucket = home_bucket(uniq, buckets)
    pending = torch.arange(len(uniq), device=keys.device)
    while pending.numel():
        b = bucket[pending]
        by_bucket, at = torch.sort(b, stable=True)
        starts = torch.searchsorted(by_bucket, by_bucket)
        rank = torch.empty_like(at)
        rank[at] = torch.arange(len(at), device=keys.device) - starts
        slot = fill[b] + rank
        put = slot < SLOTS
        where = b[put] * SLOTS + slot[put]
        hkeys[where] = uniq[pending[put]]
        hrows[where] = least[pending[put]]
        fill += torch.bincount(b[put], minlength=buckets)
        pending = pending[~put]
        bucket[pending] = (bucket[pending] + 1) % buckets
    return hkeys, hrows


def lookup_plain(hkeys: torch.Tensor, hrows: torch.Tensor,
                 q: torch.Tensor, live: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows int32[*q.shape], probes int64[*q.shape]): each live query's row
    in the hash of ``hash_plain`` (-1 if absent; -1 and no probe where not
    live), reading buckets from its home to the first that is not full, and
    the buckets it read."""
    buckets = hkeys.shape[0] // SLOTS
    table = hkeys.view(buckets, SLOTS)
    flat, ok = q.reshape(-1), live.reshape(-1)
    out = torch.full(flat.shape, -1, dtype=torch.int64, device=q.device)
    probes = torch.zeros(flat.shape, dtype=torch.int64, device=q.device)
    pending = torch.nonzero(ok).flatten()
    bucket = home_bucket(flat[pending], buckets)
    while pending.numel():
        slots = table[bucket]
        hit = slots == flat[pending, None]
        found = hit.any(dim=1)
        at = bucket[found] * SLOTS + hit[found].to(torch.int8).argmax(dim=1)
        out[pending[found]] = hrows[at]
        probes[pending] += 1
        full = slots[:, SLOTS - 1] != -1
        pending, bucket = pending[full], (bucket[full] + 1) % buckets
    return out.to(torch.int32).reshape(q.shape), probes.reshape(q.shape)


def _check(keys: Sequence[torch.Tensor], problems: Sequence[Problem]) -> torch.device:
    if not keys:
        raise ValueError("map6_many: no tables")
    if len(problems) > MAX_PROBLEMS:
        raise ValueError(f"map6_many: at most {MAX_PROBLEMS} maps a call, got {len(problems)}")
    device = keys[0].device
    for t in keys:
        if t.dtype != torch.int64:
            raise TypeError(f"map6_many: keys must be int64, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"map6_many: keys must be 1-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("map6_many: keys must be contiguous")
        if t.device != device:
            raise ValueError("map6_many: every tensor must share one device")
        if hash_buckets(t.shape[0]) > 1 << MAX_LOG2_BUCKETS:
            raise ValueError(f"map6_many: a table holds at most {1 << MAX_LOG2_BUCKETS} rows")
    if len({i for _, i, _, _ in problems}) > MAX_TABLES:
        raise ValueError(f"map6_many: at most {MAX_TABLES} tables searched a call")
    for out_t, in_t, deltas, scale in problems:
        if not (0 <= out_t < len(keys) and 0 <= in_t < len(keys)):
            raise ValueError(f"map6_many: table index out of range in ({out_t}, {in_t})")
        if deltas.dtype != torch.int64:
            raise TypeError(f"map6_many: deltas must be int64, got {deltas.dtype}")
        if deltas.dim() != 1 or deltas.shape[0] < 1:
            raise ValueError(f"map6_many: deltas must be int64[K], K >= 1; got "
                             f"{tuple(deltas.shape)}")
        if not deltas.is_contiguous():
            raise ValueError("map6_many: deltas must be contiguous")
        if deltas.device != device:
            raise ValueError("map6_many: every tensor must share one device")
        if not isinstance(scale, int):
            raise TypeError(f"map6_many: scale must be an int, got {type(scale).__name__}")
    return device


def map6_many(keys: Sequence[torch.Tensor], problems: Sequence[Problem]) -> List[torch.Tensor]:
    """[int32[len(keys[out]), len(deltas)]] for every ``(out, in, deltas,
    scale)``: the maps of one call. CUDA tensors hash every searched table
    (at most ``MAX_TABLES``) in one launch and write every map in another
    (the call counted in ``map6_many.launches``), the counters
    ``map6.queries`` and ``map6.probes`` tallied on the card; CPU tensors
    run ``hash_plain`` and ``lookup_plain``."""
    keys, problems = list(keys), list(problems)
    device = _check(keys, problems)
    if not problems:
        return []
    if device.type == "cpu":
        outs = [torch.empty((keys[o].shape[0], d.shape[0]), dtype=torch.int32)
                for o, _, d, _ in problems]
        hashes = {i: hash_plain(keys[i], hash_buckets(keys[i].shape[0]))
                  for i in sorted({i for _, i, _, _ in problems})}
        queries = probes = 0
        for (o, i, deltas, scale), out in zip(problems, outs):
            live = (keys[o] < PAD_QUERY_KEY)[:, None].expand_as(out)
            q = torch.where(live, keys[o][:, None] + scale * deltas[None], -1)
            rows, n = lookup_plain(*hashes[i], q, live)
            out.copy_(rows)
            queries, probes = queries + int(live.sum()), probes + int(n.sum())
        timer.count_device({"map6.queries": queries, "map6.probes": probes})
        return outs
    if device.type != "cuda":
        raise ValueError(f"map6_many: unsupported device {device}")
    outs = [torch.empty((keys[o].shape[0], d.shape[0]), dtype=torch.int32, device=device)
            for o, _, d, _ in problems]
    live = [(p, out) for p, out in zip(problems, outs) if out.numel()]
    searched = sorted({i for _, i, _, _ in problems})
    scratch = torch.empty((scratch_bytes([keys[i].shape[0] for i in searched]),),
                          dtype=torch.uint8, device=device)
    words = torch.empty((2,), dtype=torch.int64, device=device)
    base, tables = scratch.data_ptr(), []
    for i in searched:
        b = hash_buckets(keys[i].shape[0])
        tables.append(_Map6Table(keys[i].data_ptr(), base, base + b * SLOTS * 8,
                                 keys[i].shape[0], b.bit_length() - 1))
        base += b * SLOTS * 12
    probs = [_Map6Problem(keys[o].data_ptr(), d.data_ptr(), out.data_ptr(), out.shape[0],
                          scale, d.shape[0], searched.index(i))
             for (o, i, d, scale), out in live]
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.map6_many((_Map6Table * len(tables))(*tables), len(tables),
                           (_Map6Problem * max(1, len(probs)))(*probs), len(probs),
                           scratch.data_ptr(), scratch.numel(), words.data_ptr(), stream)
        cuda_build.check(rc, "map6_many")
        timer.count_device({"map6.queries": words[0:1], "map6.probes": words[1:2]})
    launches.count(map6_many)
    return outs


map6_many.launches = 0


class _Map6Table(ctypes.Structure):
    """``Map6Table`` of ``csrc/map6.cu``."""
    _fields_ = [("keys", ctypes.c_void_p), ("hkeys", ctypes.c_void_p),
                ("hrows", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("log2_buckets", ctypes.c_int)]


class _Map6Problem(ctypes.Structure):
    """``Map6Problem`` of ``csrc/map6.cu``."""
    _fields_ = [("qkeys", ctypes.c_void_p), ("deltas", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("scale", ctypes.c_longlong), ("k", ctypes.c_int), ("table", ctypes.c_int)]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("map6")
    lib.map6_many.restype = ctypes.c_int
    lib.map6_many.argtypes = [ctypes.POINTER(_Map6Table), ctypes.c_int,
                              ctypes.POINTER(_Map6Problem), ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return lib
