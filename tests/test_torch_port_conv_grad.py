"""Port parity, sparse-conv gradients: dX (kernel A's plain version through
the inverse map) and dW of ``sparse.ops.sparse_conv`` against ``jax.grad``
through the JAX package's ``_conv_with_transpose_bwd``, on the maps of a
real small pyramid, and ``torch.autograd.gradcheck`` of the Function in f64."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.sparse.ops import _conv_with_transpose_bwd

from imfnet_tpu_torch.sparse.kernel_map import build_pyramid
from imfnet_tpu_torch.sparse.ops import _SparseConv, sparse_conv, weight_grad

CAPS = (512, 256, 128, 64)


def _cloud(rng, n, batch, span=10):
    pts = np.unique(rng.randint(-span, span, (4 * n, 3)), axis=0)[:n]
    return np.concatenate([np.full((len(pts), 1), batch), pts], 1).astype(np.int32)


@pytest.fixture(scope="module")
def pyramid():
    rng = np.random.RandomState(3)
    coords = np.concatenate([_cloud(rng, 200, 0), _cloud(rng, 150, 1)])
    order = np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1], coords[:, 0]))
    padded = np.full((CAPS[0], 4), -(1 << 20), np.int32)
    padded[:len(coords)] = coords[order]
    return build_pyramid(torch.from_numpy(padded), torch.tensor(len(coords), dtype=torch.int32),
                         conv1_kernel_size=5, level_capacity=CAPS)


def _maps(pyr, kind):
    """(nbr, nbr_inv, n_in) of one conv of the model."""
    lv = pyr.levels
    return {"same": (lv[1].k3_same, lv[1].k3_same, CAPS[1]),
            "down": (lv[1].down, lv[0].up, CAPS[0]),
            "up": (lv[0].up, lv[1].down, CAPS[1]),
            "conv1": (pyr.k5_l0, pyr.k5_l0, CAPS[0])}[kind]


CASES = [("same", 16, 16), ("down", 8, 16), ("up", 24, 8), ("conv1", 1, 8)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("kind,cin,cout", CASES)
def test_conv_gradients_match_jax(pyramid, kind, cin, cout, dtype, tol):
    nbr, nbr_inv, n_in = _maps(pyramid, kind)
    n_out, k = nbr.shape
    rng = np.random.RandomState(11)
    x = rng.randn(n_in, cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) * (k * cin) ** -0.5).astype(np.float32)
    cot = rng.randn(n_out, cout).astype(np.float32)

    def jax_loss(xj, wj):
        out = _conv_with_transpose_bwd(getattr(jnp, dtype), False, xj,
                                       jnp.asarray(nbr.numpy()),
                                       jnp.asarray(nbr_inv.numpy()), wj)
        return jnp.sum(out * cot), out

    (_, ref_out), (ref_dx, ref_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_conv(xt, nbr, wt, compute_dtype=getattr(torch, dtype), nbr_inv=nbr_inv)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, got, ref in (("out", out.detach(), ref_out), ("dx", xt.grad, ref_dx),
                           ("dw", wt.grad, ref_dw)):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * max(1.0, np.abs(ref).max()), err_msg=name)


def test_conv1_input_needs_no_gradient(pyramid):
    """conv1's input (occupancy features) never requires a gradient: dW alone
    is computed, and without ``nbr_inv``."""
    nbr, _, n_in = _maps(pyramid, "conv1")
    x = torch.ones((n_in, 1))
    w = torch.randn((125, 1, 8), generator=torch.Generator().manual_seed(0)).requires_grad_()
    sparse_conv(x, nbr, w, compute_dtype=torch.float32).sum().backward()
    live = (nbr >= 0).float()
    np.testing.assert_allclose(w.grad[:, 0, :].numpy(),
                               live.sum(0)[:, None].expand(-1, 8).numpy(), rtol=1e-6)


def test_gradient_of_features_without_inverse_raises(pyramid):
    nbr, _, n_in = _maps(pyramid, "same")
    x = torch.randn((n_in, 8)).requires_grad_()
    w = torch.randn((27, 8, 8)).requires_grad_()
    with pytest.raises(ValueError, match="nbr_inv"):
        sparse_conv(x, nbr, w, compute_dtype=torch.float32)
    with torch.no_grad():                       # inference needs none
        sparse_conv(x, nbr, w, compute_dtype=torch.float32)


def test_weight_grad_chunks_agree(pyramid, monkeypatch):
    """dW over chunks of offsets equals dW in one product."""
    from imfnet_tpu_torch.sparse import ops
    nbr, _, n_in = _maps(pyramid, "same")
    g = torch.Generator().manual_seed(2)
    x = torch.randn((n_in, 16), generator=g)
    dy = torch.randn((nbr.shape[0], 8), generator=g)
    whole = weight_grad(x, nbr, dy)
    monkeypatch.setattr(ops, "DW_CHUNK_BYTES", nbr.shape[0] * 16 * 4 * 5)   # 5 offsets
    np.testing.assert_allclose(weight_grad(x, nbr, dy).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["same", "down", "up"])
def test_function_gradcheck_f64(kind):
    """``torch.autograd.gradcheck`` of the Function on its plain version in
    f64, on the maps of a tiny pyramid (the inverse must be exact)."""
    rng = np.random.RandomState(5)
    coords = _cloud(rng, 40, 0, span=4)
    order = np.lexsort((coords[:, 3], coords[:, 2], coords[:, 1], coords[:, 0]))
    caps = (64, 32, 16, 8)
    padded = np.full((caps[0], 4), -(1 << 20), np.int32)
    padded[:len(coords)] = coords[order]
    pyr = build_pyramid(torch.from_numpy(padded), torch.tensor(len(coords), dtype=torch.int32),
                        conv1_kernel_size=3, level_capacity=caps)
    lv = pyr.levels
    nbr, nbr_inv, n_in = {"same": (lv[0].k3_same, lv[0].k3_same, caps[0]),
                          "down": (lv[1].down, lv[0].up, caps[0]),
                          "up": (lv[0].up, lv[1].down, caps[1])}[kind]
    g = torch.Generator().manual_seed(1)
    x = torch.randn((n_in, 3), dtype=torch.float64, generator=g).requires_grad_()
    w = torch.randn((27, 3, 2), dtype=torch.float64, generator=g).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: _SparseConv.apply(a, b, nbr, nbr_inv, torch.float64), (x, w),
        eps=1e-6, atol=1e-8)
