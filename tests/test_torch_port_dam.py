"""Port parity, DAM: the point-side activation map (cumulative and per
channel), the image saliency, the colours, the PLY and the overlay against
the JAX package's functions on the same fragment and weights, and ``cli dam``
on the CPU against the JAX command's files (``test_torch_port_dam_cli.py``).
The JAX attribution functions run jitted."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import imfnet_tpu.dam.dam as jdam
from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.geom.ply import read_ply as jax_read_ply
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.grid import GridSpec as JaxGridSpec
from imfnet_tpu.sparse.grid import quantize_grid as jax_quantize_grid
from imfnet_tpu.train.step import make_pyramid_fn as jax_make_pyramid_fn

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.dam import dam
from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.eval.extract import pad_points
from imfnet_tpu_torch.geom.image import load_image
from imfnet_tpu_torch.geom.ply import read_ply
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.sparse.grid import GridSpec, quantize_grid
from imfnet_tpu_torch.train.step import make_pyramid_fn
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

from test_torch_port_model import _randomize

N_PAD = 512
HW = (24, 32)
CFG = dict(conv1_kernel_size=3, model_n_out=8, max_points=N_PAD, compute_dtype="float32",
           image_H=HW[0], image_W=HW[1], grid_extent=(64, 64, 64), use_grid_maps=False)
TARGET = 5
DAM_RTOL = 1e-4    # of the map's largest value: f32, the same sums in another order
SAL_RTOL = 1e-4    # of the saliency's largest value, likewise through the backward


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """One fragment (476 voxels) at 512 rows on both sides, flax variables
    of a ResUNetBN2C with randomized norms, and the port's model with them."""
    jcfg, cfg = jax_config(**CFG), threedmatch_config(**CFG)
    pair = synthetic_pair(np.random.RandomState(0), n_points=600, voxel_size=cfg.voxel_size,
                          extent=0.6, image_hw=HW)
    raw, n = pad_points(pair.xyz0, 1024)
    image = np.random.RandomState(1).rand(1, *HW, 3).astype(np.float32)
    sv_j, _, xd_j = jax_quantize_grid(jnp.asarray(raw), jnp.ones((1024, 1)),
                                      jnp.arange(1024) < n, cfg.voxel_size, N_PAD,
                                      JaxGridSpec(extent=(64, 64, 64), num_batches=1))
    pyr_j = jax_make_pyramid_fn(jcfg, N_PAD, 1)(sv_j.coords, sv_j.num_valid)
    jmodel = jax_load_model(cfg.model)(in_channels=1, out_channels=8, conv1_kernel_size=3,
                                       compute_dtype=jnp.float32)
    v = jax.jit(lambda s, p, i: jmodel.init(jax.random.PRNGKey(0), s, p, i, train=False))(
        sv_j, pyr_j, jnp.asarray(image))
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(v)), np.random.RandomState(2))

    sv, _, xd = quantize_grid(torch.from_numpy(raw), torch.ones(1024, 1),
                              torch.arange(1024) < n, cfg.voxel_size, N_PAD,
                              GridSpec(extent=(64, 64, 64), num_batches=1))
    np.testing.assert_array_equal(sv.coords.numpy(), np.asarray(sv_j.coords))
    pyr = make_pyramid_fn(cfg, N_PAD, 1)(sv.coords, sv.num_valid)
    model = load_model(cfg.model)(in_channels=1, out_channels=8, conv1_kernel_size=3,
                                  compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, variables=variables, sv_j=sv_j, pyr_j=pyr_j,
                sv=sv, pyr=pyr, xyz=xd.numpy(), image=image, pair=pair, model=model.eval())


def _jit(fn, model, target, **kw):
    return jax.jit(lambda v, s, p, i: fn(model, v, s, p, i, target, **kw))


@pytest.mark.parametrize("cumulative", [True, False])
def test_descriptor_activation_map_equals_jax(setup, cumulative):
    s = setup
    want = np.asarray(_jit(jdam.descriptor_activation_map, s["jmodel"], TARGET,
                           cumulative=cumulative)(s["variables"], s["sv_j"], s["pyr_j"],
                                                  jnp.asarray(s["image"])))
    got = dam.descriptor_activation_map(s["model"], s["sv"], s["pyr"],
                                        torch.from_numpy(s["image"]), TARGET,
                                        cumulative=cumulative).numpy()
    assert got.shape == want.shape == (N_PAD,)
    assert (got >= 0).all() and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=DAM_RTOL * want.max())


def test_cumulative_is_the_reference_sum_of_channel_gradients(setup):
    """channel i sees Σ_{j≤i} g_j (`base_dam.py:141-160`): the cumulative
    map equals the per-channel formula applied to running sums, which here
    are taken by 8 whole-model backward passes without zeroing."""
    s = setup
    model = s["model"]
    out = model(s["sv"], s["pyr"], torch.from_numpy(s["image"]))
    grads = []
    model.zero_grad()
    for i in range(out.shape[1]):
        out[TARGET, i].backward(retain_graph=True)
        grads.append(model.final.weight.grad.clone())   # accumulates, as the reference
    model.zero_grad()
    seen = {}
    h = model.final.register_forward_hook(lambda m, a, o: seen.__setitem__("y", o))
    with torch.no_grad():
        model(s["sv"], s["pyr"], torch.from_numpy(s["image"]))
    h.remove()
    want = torch.relu(sum(seen["y"] @ g.mean(dim=0) for g in grads))
    got = dam.descriptor_activation_map(model, s["sv"], s["pyr"],
                                        torch.from_numpy(s["image"]), TARGET)
    torch.testing.assert_close(got, want, rtol=0, atol=DAM_RTOL * float(want.max()))


def test_image_activation_map_equals_jax(setup):
    s = setup
    want = np.asarray(_jit(jdam.image_activation_map, s["jmodel"], TARGET)(
        s["variables"], s["sv_j"], s["pyr_j"], jnp.asarray(s["image"])))
    got = dam.image_activation_map(s["model"], s["sv"], s["pyr"],
                                   torch.from_numpy(s["image"]), TARGET).numpy()
    assert got.shape == want.shape == HW and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=SAL_RTOL * want.max())


def test_colours_and_ply_equal_jax(setup, tmp_path):
    rng = np.random.RandomState(3)
    w = np.abs(rng.randn(N_PAD)).astype(np.float32)
    n = int(setup["sv"].num_valid)
    np.testing.assert_array_equal(dam.dam_colors(w, n), jdam.dam_colors(w, n))
    flat = np.full(N_PAD, 0.5, np.float32)
    np.testing.assert_array_equal(dam.dam_colors(flat, n), jdam.dam_colors(flat, n))
    for mod, name in ((dam, "port"), (jdam, "jax")):
        mod.save_dam_ply(str(tmp_path / f"{name}.ply"), setup["xyz"], w, n)
    a, b = read_ply(str(tmp_path / "port.ply")), jax_read_ply(str(tmp_path / "jax.ply"))
    assert set(a) == set(b) and len(a["points"]) == n
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_overlay_equals_jax(setup, tmp_path):
    sal = np.random.RandomState(4).rand(*HW)
    dam.save_dam_image_overlay(str(tmp_path / "port.png"), setup["image"][0], sal)
    jdam.save_dam_image_overlay(str(tmp_path / "jax.png"), setup["image"][0], sal)
    a, b = load_image(str(tmp_path / "port.png")), load_image(str(tmp_path / "jax.png"))
    assert a.shape == HW + (3,)
    np.testing.assert_array_equal(a, b)
