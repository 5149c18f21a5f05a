"""Why the port's training-step gradients are held to the JAX package's on
batch seeds 0 and 1 (``test_torch_port_train.py``, ``test_torch_port_dp.py``)
and not on seed 21.

On seed 21 (700 points, n_pad 2 048: levels 1-3 full, keeping the first
rows in scan order) one step's loss and running statistics agree with JAX,
but ``block4.conv0``'s gradient differs by 13 % of its largest entry and
``block4.norm0``'s bias gradient by 5 %. The tests here show that the port's
gradient is the exact derivative of the loss both packages compute:

- every level's rows and row count equal JAX's ``build_pyramid``'s, so the
  truncated levels keep the same rows;
- the f32 gradients equal the f64 ones (1e-3 of each tensor's largest
  entry): the port's result does not hang on its f32 summation order;
- a central difference of the f64 loss at a step of 1e-8 along
  ``block4.conv0``'s gradient equals the gradient's projection.

Run as a script from the repository's root, ``PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_port_grad_kink.py`` (a few
minutes on a CPU: JAX runs un-jitted), it also projects both packages'
gradients of ``block4.conv0`` and ``block4.norm0``'s bias on the direction
where they differ, beside central differences of the port's f64 loss at
steps 1e-4, 1e-6 and 1e-8. The port's projection is the 1e-8 difference;
the larger steps cross a kink of the loss (a ReLU or hinge input within
about 1e-6 of zero), on whose other side JAX's f32 rounding evaluates the
derivative.
"""
import numpy as np
import pytest
import torch

import jax

from imfnet_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.train import step as jstep

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_batch
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.train.step import compute_correspondences, make_loss_fn, make_pyramid_fn

from test_torch_port_train import N_PAD, RADIUS, SMALL, _one_torch_thread  # noqa: F401

SEED = 21
TORCH_FLOAT = torch.Tensor.float


def _batch(seed=SEED):
    b = synthetic_batch(np.random.RandomState(seed), batch_size=2, n_points=700, n_pad=N_PAD,
                        image_hw=(24, 32), device="cpu")
    pairs, ok = compute_correspondences(b, RADIUS)
    return b._replace(pairs=pairs, pair_valid=ok)


def _f64_casts(on: bool):
    """The port casts to f32 with ``Tensor.float()`` (batch norms, the
    loss's distances); for an f64 reference those casts keep f64."""
    torch.Tensor.float = ((lambda t, *a, **k: t if t.dtype == torch.float64
                           else TORCH_FLOAT(t, *a, **k)) if on else TORCH_FLOAT)


def _grads(cfg, state_dict, batch, draws, dtype):
    """(loss_fn, model, {name: gradient}) of one training-mode loss in
    ``dtype`` from ``state_dict``."""
    model = load_model(cfg.model)(in_channels=1, out_channels=cfg.model_n_out,
                                  conv1_kernel_size=cfg.conv1_kernel_size,
                                  compute_dtype=dtype, bn_momentum=cfg.bn_momentum)
    model.load_state_dict(state_dict)
    model = model.to(dtype)
    if dtype == torch.float64:
        batch = batch._replace(**{f: getattr(batch, f).double() for f in batch._fields
                                  if torch.is_tensor(getattr(batch, f))
                                  and getattr(batch, f).is_floating_point()})
        draws = [d.double() for d in draws]
    model.train()
    loss_fn = make_loss_fn(model, cfg, "search")
    loss, _ = loss_fn(batch, draws=draws)
    loss.backward()
    grads = {n: p.grad.detach().double().clone() for n, p in model.named_parameters()}
    return (lambda: float(loss_fn(batch, draws=draws)[0])), model, grads


def _setup():
    cfg = threedmatch_config(**SMALL)
    torch.manual_seed(0)
    model = load_model(cfg.model)(in_channels=1, out_channels=cfg.model_n_out,
                                  conv1_kernel_size=cfg.conv1_kernel_size,
                                  compute_dtype=torch.float32, bn_momentum=cfg.bn_momentum)
    g = torch.Generator().manual_seed(7)
    draws = [torch.rand(N_PAD, generator=g) for _ in range(3)]
    return cfg, model.state_dict(), _batch(), draws


def central_difference(loss, param, v, eps):
    with torch.no_grad():
        param.add_(eps * v)
        up = loss()
        param.sub_(2 * eps * v)
        down = loss()
        param.add_(eps * v)
    return (up - down) / (2 * eps)


def test_truncated_levels_keep_the_rows_jax_keeps():
    b = _batch()
    jb = jax_synthetic_batch(np.random.RandomState(SEED), batch_size=2, n_points=700,
                             n_pad=N_PAD, image_hw=(24, 32))
    caps = jstep.level_capacities(N_PAD)
    cfg = threedmatch_config(**SMALL)
    for side in (0, 1):
        want = jax.jit(lambda c, n: jax_build_pyramid(c, n, conv1_kernel_size=3,
                                                      level_capacity=caps))(
            getattr(jb, f"coords{side}"), getattr(jb, f"n{side}"))
        got = make_pyramid_fn(cfg, N_PAD, 2, map_impl="search")(getattr(b, f"coords{side}"),
                                                                  getattr(b, f"n{side}"))
        full = 0
        for lw, lg in zip(want.levels, got.levels):
            n = int(lg.num_valid)
            assert n == int(lw.num_valid)
            full += n == lg.coords.shape[0]
            np.testing.assert_array_equal(lg.coords[:n].numpy(), np.asarray(lw.coords)[:n])
        assert full == 3        # levels 1-3 are truncated at their capacity


def test_f32_gradients_equal_f64_and_the_central_difference():
    cfg, sd, batch, draws = _setup()
    _, _, g32 = _grads(cfg, sd, batch, draws, torch.float32)
    _f64_casts(True)
    try:
        loss, model, g64 = _grads(cfg, sd, batch, draws, torch.float64)
        for name, r in g64.items():
            np.testing.assert_allclose(g32[name].numpy(), r.numpy(), rtol=0,
                                       atol=1e-3 * max(float(r.abs().max()), 1e-12),
                                       err_msg=name)
        p = dict(model.named_parameters())["block4.conv0.weight"]
        v = g64["block4.conv0.weight"] / g64["block4.conv0.weight"].norm()
        fd = central_difference(loss, p, v, 1e-8)
        assert fd == pytest.approx(float((g64["block4.conv0.weight"] * v).sum()), rel=1e-4)
    finally:
        _f64_casts(False)


def main():
    """Prints both packages' projected gradients beside the port's central
    differences (the readings of this module's docstring)."""
    import jax.numpy as jnp

    from imfnet_tpu.config import threedmatch_config as jax_config
    from imfnet_tpu.sparse.coords import SparseVoxels as JaxSparseVoxels

    from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax
    from test_torch_port_train import _draws, _jax_model, _np

    torch.set_num_threads(4)
    jcfg, cfg = jax_config(use_grid_maps=False, **SMALL), threedmatch_config(**SMALL)
    batch = _batch()
    jb = jax_synthetic_batch(np.random.RandomState(SEED), batch_size=2, n_points=700,
                             n_pad=N_PAD, image_hw=(24, 32))
    jb = jb._replace(pairs=jnp.asarray(batch.pairs.numpy()),
                     pair_valid=jnp.asarray(batch.pair_valid.numpy()))
    jmodel = _jax_model(jcfg)
    pyr = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, conv1_kernel_size=3, level_capacity=jstep.level_capacities(N_PAD)))(
            jb.coords0, jb.n0)
    variables = _np(dict(jax.jit(lambda s, p, i: jmodel.init(
        jax.random.PRNGKey(0), s, p, i, train=False))(
            JaxSparseVoxels(jb.coords0, jb.feats0, jb.n0), pyr, jb.image0)))
    key = jax.random.PRNGKey(7)
    with jax.disable_jit():
        (jloss, _), jgrads = jax.value_and_grad(jstep.make_loss_fn(jmodel, jcfg), has_aux=True)(
            variables["params"], variables["batch_stats"], jb, key)
    jg = {k: v.double() for k, v in state_dict_from_flax({"params": _np(jgrads)}).items()}
    draws = _draws(key, (N_PAD, N_PAD, N_PAD))
    sd = state_dict_from_flax(variables)
    _, _, g32 = _grads(cfg, sd, batch, draws, torch.float32)
    _f64_casts(True)
    try:
        loss, model, g64 = _grads(cfg, sd, batch, draws, torch.float64)
        print(f"loss: JAX f32 {float(jloss):.9g}, port f64 {loss():.9g}")
        params = dict(model.named_parameters())
        for name in ("block4.conv0.weight", "block4.norm0.bn.bias"):
            rel = lambda a: float((a - g64[name]).abs().max() / g64[name].abs().max())  # noqa: E731
            print(f"{name}: largest gap to the port's f64 gradient, of its largest entry: "
                  f"port f32 {rel(g32[name]):.3g}, JAX f32 {rel(jg[name]):.3g}")
            v = g64[name] - jg[name]
            v = v / v.norm()
            proj = {k: float((g[name] * v).sum()) for k, g in
                    (("port f64", g64), ("port f32", g32), ("JAX f32", jg))}
            fds = {eps: central_difference(loss, params[name], v, eps)
                   for eps in (1e-4, 1e-6, 1e-8)}
            print(f"  projected on port - JAX: {proj}; central differences of the port's "
                  f"f64 loss by step: {fds}")
    finally:
        _f64_casts(False)


if __name__ == "__main__":
    main()
