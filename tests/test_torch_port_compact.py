"""Kernel C's single-pass scheme, emulated tile by tile in plain Python
against ``sorted_compact_plain``.

The CUDA kernel (``csrc/sorted_compact.cu``) runs only on the card; what can
be held here is its scheme: tickets hand out the tiles, a tile counts its run
starts and publishes the count in a tagged status word, sums the words of the
tiles before it down to the nearest inclusive prefix, scatters its starts'
rows, and the last tile fills the unused slots. The emulation runs the
blocks of a call in a random interleaving and several calls on one state,
which is never reset, as the kernel's is not."""
import numpy as np
import pytest
import torch

from imfnet_tpu_torch.sparse.quant_kernel import INVALID_KEY, TILE, sorted_compact_plain

AGGREGATE, INCLUSIVE = 1, 2


def emulate_call(sk, order, n_out, tile_rows, state, rng):
    """One call of the scheme on ``state`` = {"ticket": int, "words": list of
    (tag, kind, count)}; blocks advance in a random interleaving. Returns
    (sel, count)."""
    n = len(sk)
    num_tiles = -(-n // tile_rows)
    sel = np.full(n_out, -99, np.int64)         # -99: a slot nothing wrote
    count = None
    words = state["words"]
    blocks = []
    for _ in range(num_tiles):                  # a block starts: it draws a ticket
        ticket = state["ticket"]
        state["ticket"] += 1
        blocks.append({"tile": ticket % num_tiles, "tag": ticket // num_tiles + 1, "stage": 0})
    pending = list(range(num_tiles))
    while pending:
        b = blocks[pending[rng.randint(len(pending))]]
        t, tag = b["tile"], b["tag"]
        lo, hi = t * tile_rows, min((t + 1) * tile_rows, n)
        keys = sk[lo:hi]
        prev = np.concatenate([[-1 if lo == 0 else sk[lo - 1]], keys[:-1]])
        flags = (keys != INVALID_KEY) & (keys != prev)
        if b["stage"] == 0:                     # count and publish
            words[t] = (tag, INCLUSIVE if t == 0 else AGGREGATE, int(flags.sum()))
            b["stage"] = 1
            continue
        exclusive, p, ready = 0, t - 1, True    # look back, nearest tile first
        while p >= 0:
            w_tag, kind, c = words[p]
            if w_tag != tag:                    # not published in this call yet: wait
                ready = False
                break
            exclusive += c
            if kind == INCLUSIVE:
                break
            p -= 1
        if not ready:
            continue
        words[t] = (tag, INCLUSIVE, exclusive + int(flags.sum()))
        pos = exclusive + np.cumsum(flags) - 1
        keep = flags & (pos < n_out)
        sel[pos[keep]] = order[lo:hi][keep]
        if t == num_tiles - 1:
            total = exclusive + int(flags.sum())
            sel[total:] = -1
            count = min(total, n_out)
        pending.remove(blocks.index(b))
    return sel, count


def _stream(kind, n, rng):
    rows = np.arange(n)
    if kind == "all invalid":
        sk = np.full(n, INVALID_KEY, np.int64)
    elif kind == "one run":
        sk = np.full(n, 7, np.int64)
    elif kind == "every row its own run":
        sk = rows.astype(np.int64) * 3
    else:   # random runs with invalid rows last
        sk = np.sort(np.where(rng.rand(n) < 0.2, INVALID_KEY, rng.randint(0, max(n // 3, 1), n)))
    return sk.astype(np.int64), rng.permutation(n).astype(np.int64)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
@pytest.mark.parametrize("kind", ["random runs", "all invalid", "one run",
                                  "every row its own run"])
@pytest.mark.parametrize("slots", ["enough", "too few"])
def test_single_pass_scheme_equals_plain(n, kind, slots):
    rng = np.random.RandomState(n)
    sk, order = _stream(kind, n, rng)
    n_out = n + 5 if slots == "enough" else max(n // 7, 1)
    ref_sel, ref_count = sorted_compact_plain(torch.from_numpy(sk), torch.from_numpy(order), n_out)
    tile_rows = 256                             # several tiles at these sizes
    state = {"ticket": 0, "words": [(0, 0, 0)] * -(-n // tile_rows)}
    for call in range(3):                       # the state is never reset
        sel, count = emulate_call(sk, order, n_out, tile_rows, state, rng)
        np.testing.assert_array_equal(sel, ref_sel.numpy(), err_msg=f"call {call}")
        assert count == int(ref_count)


def test_scheme_at_the_kernels_tile():
    """A ragged stream of a few of the kernel's own tiles."""
    rng = np.random.RandomState(0)
    n = 3 * TILE + 17
    sk, order = _stream("random runs", n, rng)
    ref_sel, ref_count = sorted_compact_plain(torch.from_numpy(sk), torch.from_numpy(order), 2000)
    state = {"ticket": 0, "words": [(0, 0, 0)] * 4}
    sel, count = emulate_call(sk, order, 2000, TILE, state, rng)
    np.testing.assert_array_equal(sel, ref_sel.numpy())
    assert count == int(ref_count) and state["ticket"] == 4
