"""The port's CUDA kernels against their plain versions, on the card.

Kernels build with nvcc and run only on an NVIDIA GPU (sm_90a); without one
every test here skips (the fixture decides, at run time). On the GPU
machine:

    python -m pytest tests/test_torch_port_kernels.py -q
"""
import pytest
import torch

from imfnet_tpu_torch.match.nn_kernel import flash_nn, nn_plain
from imfnet_tpu_torch.sparse.conv_kernel import gather_gemm, gather_gemm_plain


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _map(gen, n_in, n_out, k=27, miss=0.6):
    nbr = torch.randint(0, n_in, (n_out, k), generator=gen, device="cuda")
    drop = torch.rand((n_out, k), generator=gen, device="cuda") < miss
    return torch.where(drop, -1, nbr).to(torch.int32).contiguous()


# the ten (cin, cout) pairs of the main path's convs, and a cin that is not a
# power of two
SHAPES = [(32, 32), (64, 64), (128, 128), (256, 256), (32, 64), (64, 128),
          (128, 256), (256, 128), (256, 64), (128, 64), (48, 40)]


@pytest.mark.parametrize("cin,cout", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_gemm_matches_plain(gen, cin, cout, dtype):
    """Both sum exact products in f32, in another order: 1e-4 relative."""
    x = torch.randn((700, cin), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((27, cin, cout), generator=gen, device="cuda") * 0.05).to(dtype)
    nbr = _map(gen, 700, 900)
    nbr[5] = -1
    nbr[-70:] = -1
    out = gather_gemm(x, nbr, w)
    ref = gather_gemm_plain(x, nbr, w)
    torch.cuda.synchronize()
    assert (out[5] == 0).all() and (out[-70:] == 0).all()
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * max(1.0, ref.abs().max().item()))


def test_gather_gemm_counts_launches(gen):
    x = torch.randn((50, 32), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((27, 32, 32), generator=gen, device="cuda").to(torch.bfloat16)
    before = gather_gemm.launches
    gather_gemm(x, _map(gen, 50, 60), w)
    assert gather_gemm.launches == before + 1


@pytest.mark.parametrize("d", [32, 3])
@pytest.mark.parametrize("valid_kind", ["all", "some", "one", "none"])
def test_flash_nn_matches_plain(gen, d, valid_kind):
    q = torch.randn((1000, d), generator=gen, device="cuda")
    r = torch.randn((1500, d), generator=gen, device="cuda")
    valid = {"all": torch.ones(1500, dtype=torch.bool, device="cuda"),
             "some": torch.rand(1500, generator=gen, device="cuda") > 0.3,
             "one": torch.arange(1500, device="cuda") == 777,
             "none": torch.zeros(1500, dtype=torch.bool, device="cuda")}[valid_kind]
    before = flash_nn.launches
    i_k, d_k = flash_nn(q, r, valid)
    i_p, d_p = nn_plain(q, r, valid)
    torch.cuda.synchronize()
    assert flash_nn.launches == before + 1
    assert torch.equal(i_k, i_p)
    if valid_kind == "none":
        assert (i_k == 0).all() and torch.isinf(d_k).all()
    else:
        torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-4)


def test_flash_nn_rejects_other_widths(gen):
    with pytest.raises(ValueError, match="serves D"):
        flash_nn(torch.zeros((4, 8), device="cuda"), torch.zeros((5, 8), device="cuda"))
