"""Kernel A's wide-K walk in plain PyTorch, on the CPU: what its list build
gives each offset (the live rows, each entry's rank in its row), the tally
it reports, and its summation order (each row adding its products in
ascending offset order) against ``gather_gemm_plain``
(``sparse/conv_kernel.py``: ``tcw_lists_plain``, ``tcw_tally_plain``,
``gather_gemm_tcw_plain``). The launched walk is held to the same plain
versions on the card in ``tests/test_torch_port_dgr_card.py``."""
import pytest
import torch

from imfnet_tpu_torch.sparse import conv_kernel
from imfnet_tpu_torch.sparse.conv_kernel import (TCW_GROUP, gather_gemm_plain,
                                                 gather_gemm_tcw_plain, tcw_lists_plain,
                                                 tcw_tally_plain)

K6 = 3 ** 6
TOL_REL = 1e-5      # f32 sums of the same products in another order


def hand_map():
    """Five rows over five offsets: scattered, dead, all live, centre only,
    last offset only."""
    return torch.tensor([[-1, 3, -1, 0, 2],
                         [-1, -1, -1, -1, -1],
                         [4, 4, 1, 0, 3],
                         [-1, -1, 2, -1, -1],
                         [-1, -1, -1, -1, 0]], dtype=torch.int32)


def test_lists_and_ranks_of_a_hand_built_map():
    counts, rank = tcw_lists_plain(hand_map())
    assert counts.tolist() == [1, 2, 2, 2, 3]
    assert rank.tolist() == [[-1, 0, -1, 1, 2],
                             [-1, -1, -1, -1, -1],
                             [0, 1, 2, 3, 4],
                             [-1, -1, 0, -1, -1],
                             [-1, -1, -1, -1, 0]]


def test_tally_of_a_hand_built_map():
    """Ten (rank, offset) lists of one entry each."""
    got = tcw_tally_plain(hand_map())
    assert got == {"conv.slots_walked": 10 * TCW_GROUP, "conv.entries_live": 10,
                   "conv.map_slots": 25}


def test_tally_counts_16_row_groups():
    nbr = torch.full((40, 3), -1, dtype=torch.int32)
    nbr[:17, 0] = 0            # rank 0 at offset 0, 17 entries: two 16-row groups
    nbr[:16, 1] = 1            # rank 1 at offset 1, 16: one group
    assert tcw_tally_plain(nbr)["conv.slots_walked"] == 3 * TCW_GROUP
    nbr[20, 1] = 1             # rank 0 at offset 1: a list of its own
    assert tcw_tally_plain(nbr)["conv.slots_walked"] == 4 * TCW_GROUP


def test_walk_adds_each_rows_products_in_offset_order():
    x = torch.tensor([[1.0, 2.0], [0.5, -1.0], [3.0, 0.25], [-2.0, 1.5], [0.125, 4.0]])
    w = torch.randn((5, 2, 3), generator=torch.Generator().manual_seed(1))
    nbr = hand_map()
    got = gather_gemm_tcw_plain(x, nbr, w)
    for i in range(nbr.shape[0]):
        want = torch.zeros(3)
        first = True
        for k in range(nbr.shape[1]):
            j = int(nbr[i, k])
            if j < 0:
                continue
            p = x[j] @ w[k]
            want = p if first else want + p
            first = False
        assert torch.equal(got[i], want), i
    assert torch.equal(got[1], torch.zeros(3))


def _map(kind, gen, n_out=300, n_in=260):
    """int32[n_out, 729] of one kind: "dgr" (2 % live, the centre of rows
    below n_in live, the last 40 rows dead), "dense" (row 0 all live, rows
    1-20 with 60-200 live), "dead", "centre", "tail_dead" (dgr, rows past
    n_out // 2 dead)."""
    live = torch.rand((n_out, K6), generator=gen) < 0.02
    rows = torch.randint(0, n_in, (n_out, K6), generator=gen, dtype=torch.int32)
    nbr = torch.where(live, rows, torch.full_like(rows, -1))
    if kind == "dead":
        return torch.full_like(nbr, -1)
    if kind == "centre":
        nbr = torch.full_like(nbr, -1)
        nbr[:, K6 // 2] = torch.arange(n_out, dtype=torch.int32) % n_in
        return nbr
    nbr[:, K6 // 2] = torch.arange(n_out, dtype=torch.int32) % n_in
    if kind == "dense":
        nbr[0] = rows[0]
        for i in range(1, 21):
            keep = torch.rand(K6, generator=gen) < (60 + 7 * i) / K6
            nbr[i] = torch.where(keep, rows[i], nbr[i])
    if kind == "tail_dead":
        nbr[n_out // 2:] = -1
    else:
        nbr[n_out - 40:] = -1
    return nbr.contiguous()


@pytest.mark.parametrize("kind", ["dgr", "dense", "dead", "centre", "tail_dead"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_walk_sums_equal_the_plain_version(kind, dtype):
    gen = torch.Generator().manual_seed(len(kind))
    nbr = _map(kind, gen)
    x = torch.randn((260, 16), generator=gen).to(dtype)
    w = (torch.randn((K6, 16, 24), generator=gen) * 0.1).to(dtype)
    got = gather_gemm_tcw_plain(x, nbr, w)
    want = gather_gemm_plain(x, nbr, w)
    assert got.dtype == want.dtype == torch.float32
    scale = want.abs().max().clamp_min(1e-6)
    assert float((got - want).abs().max() / scale) < TOL_REL
    dead = (nbr < 0).all(dim=1)
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    counts, rank = tcw_lists_plain(nbr)
    assert int(counts.sum()) == int((nbr >= 0).sum())
    assert torch.equal(rank.max(dim=1).values + 1, (nbr >= 0).sum(dim=1))


def test_walk_in_f64_equals_the_plain_product():
    gen = torch.Generator().manual_seed(7)
    nbr = _map("dense", gen)
    x = torch.randn((260, 8), generator=gen, dtype=torch.float64)
    w = torch.randn((K6, 8, 8), generator=gen, dtype=torch.float64)
    got = gather_gemm_tcw_plain(x, nbr, w)
    assert got.dtype == torch.float64
    assert torch.allclose(got, gather_gemm_plain(x, nbr, w), rtol=0, atol=1e-11)


@pytest.mark.parametrize("n_out,k_vol,fits", [(131072, K6, True), (1 << 22, 511, True),
                                              ((1 << 22) + 1, 352, False), (1 << 22, 512, False),
                                              (4096, 1025, False)])
def test_walk_sizes_fit_its_entries(n_out, k_vol, fits):
    """A list entry holds the row (22 bits) and the rank (10); the lists
    count entries in int32, so the map's slots stay under 2^31."""
    assert conv_kernel._tcw_fits(n_out, k_vol) is fits
