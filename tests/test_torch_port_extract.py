"""Port parity, extraction: the exact quantizer, the host constructors, the
voxel-key hashing, and both extractors against the JAX package's on the
same fragments and weights: the grid path, the exact path, the escalation
to a larger bucket, and a fragment that overflows the largest bucket (the
port raises where the JAX package logs). Integers exactly equal;
descriptors at f32 within DESC_ATOL."""
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.eval import extract as jx
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse import build as jbuild
from imfnet_tpu.sparse.coords import quantize as jax_quantize
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.utils import hashing as jhash

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.eval import extract as tx
from imfnet_tpu_torch.sparse import build as tbuild
from imfnet_tpu_torch.sparse.coords import quantize
from imfnet_tpu_torch.train.trainer import build_model_from_config
from imfnet_tpu_torch.utils import hashing as thash
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

DESC_ATOL = 1e-4   # f32 descriptors, the same sums in another order
BUCKETS = (512, 1024, 2048)
HW = (24, 32)
CFG = dict(conv1_kernel_size=3, model_n_out=16, compute_dtype="float32",
           grid_extent=(64, 64, 64), grid_extent_buckets=None,
           level_capacity_divisors=(1, 2, 4, 8), image_H=HW[0], image_W=HW[1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boundary_points(voxel):
    """f32 coordinates where floor(x / v) and floor(x * (1 / v)) differ."""
    v = np.float32(voxel)
    xs = np.arange(-200, 200).astype(np.float32) * v
    cands = np.concatenate([xs, np.nextafter(xs, np.float32(np.inf)),
                            np.nextafter(xs, np.float32(-np.inf))]).astype(np.float32)
    return cands[np.floor(cands / v) != np.floor(cands * (np.float32(1) / v))]


def _cloud(seed, n, voxel):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(n, 3) * 0.4).astype(np.float32)          # negative coords
    xyz[n // 2:n // 2 + 50] = xyz[:50]                          # exact duplicates
    xyz[-40:] = xyz[:40] + np.float32(voxel) * 0.1              # same voxel, other point
    b = _boundary_points(voxel)
    xyz[100:100 + len(b) // 3, 0] = b[:len(b) // 3]            # on cell boundaries
    return xyz


@pytest.mark.parametrize("seed,n,n_out,voxel", [(0, 3000, 4096, 0.025),
                                                (1, 3000, 1024, 0.025),
                                                (2, 2000, 2048, 0.3)])
def test_quantize_equals_jax(seed, n, n_out, voxel):
    xyz = _cloud(seed, n, voxel)
    valid = np.ones(n, bool)
    valid[-300:] = False                                        # padding rows
    feats = np.random.RandomState(seed).rand(n, 2).astype(np.float32)
    svj, selj, xdj = jax_quantize(jnp.asarray(xyz), jnp.asarray(feats),
                                  jnp.asarray(valid), voxel, n_out)
    svt, selt, xdt = quantize(torch.from_numpy(xyz), torch.from_numpy(feats),
                              torch.from_numpy(valid), voxel, n_out)
    assert int(svt.num_valid) == int(svj.num_valid)
    np.testing.assert_array_equal(svt.coords.numpy(), np.asarray(svj.coords))
    np.testing.assert_array_equal(selt.numpy(), np.asarray(selj))
    np.testing.assert_array_equal(xdt.numpy(), np.asarray(xdj))
    np.testing.assert_array_equal(svt.feats.numpy(), np.asarray(svj.feats))
    # the boundary points are where a reciprocal multiply would differ
    b = torch.from_numpy(_boundary_points(voxel))
    assert (torch.floor(b / torch.tensor(voxel)) != torch.floor(b * (1 / np.float32(voxel)))).all()


def test_from_numpy_equals_jax():
    rng = np.random.RandomState(3)
    coords = np.unique(rng.randint(-30, 30, size=(500, 4)).astype(np.int32), axis=0)
    coords[:, 0] = rng.randint(0, 2, len(coords))
    coords = np.unique(coords, axis=0)
    rng.shuffle(coords)
    feats = rng.rand(len(coords), 3).astype(np.float32)
    a = jbuild.from_numpy(coords, feats, 1024)
    b = tbuild.from_numpy(coords, feats, 1024)
    np.testing.assert_array_equal(b.coords.numpy(), np.asarray(a.coords))
    np.testing.assert_array_equal(b.feats.numpy(), np.asarray(a.feats))
    assert int(b.num_valid) == int(a.num_valid)
    np.testing.assert_array_equal(tbuild.sort_coords_np(coords), jbuild.sort_coords_np(coords))


@pytest.mark.parametrize("seed", [0, 1])
def test_hashing_equals_jax(seed):
    rng = np.random.RandomState(seed)
    arr = rng.randint(-40000, 40000, size=(2000, 3)).astype(np.float64)
    np.testing.assert_array_equal(thash.fnv_hash_vec(arr), jhash.fnv_hash_vec(arr))
    table = (rng.randn(3000, 3) * 2).astype(np.float32)
    pts = np.concatenate([table[:500] + rng.uniform(-0.01, 0.01, (500, 3)),
                          rng.randn(200, 3) * 5]).astype(np.float32)
    np.testing.assert_array_equal(thash.voxel_key_rows(pts, table, 0.025),
                                  jhash.voxel_key_rows(pts, table, 0.025))


def _surface(seed, n, sx, sy):
    rng = np.random.RandomState(seed)
    uv = rng.rand(n, 2) * np.array([sx, sy])
    z = 0.2 * np.sin(uv[:, 0] * 3) * np.cos(uv[:, 1] * 2)
    return np.c_[uv, z].astype(np.float32)


# name → (raw points, path, the buckets the JAX extractor tries)
FRAGMENTS = {
    # 1.2 m: inside the 64-voxel extent; 1 797 voxels, the 2048 bucket
    "grid": (_surface(1, 3000, 1.2, 1.2), "grid", (2048,)),
    # 2 m wide: beyond the extent, the exact path; 844 voxels
    "exact": (_surface(2, 1200, 2.0, 0.5), "exact", (1024,)),
    # 600 points spread through a cube: level 1 overflows the 1024 bucket
    "escalation": ((np.random.RandomState(3).rand(600, 3) * 1.0).astype(np.float32),
                   "grid", (1024, 2048)),
}
OVERFLOW = (np.random.RandomState(4).rand(1800, 3) * 4).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    jc = jax_config(**CFG)
    model = jax_load_model(jc.model)(in_channels=1, out_channels=16, conv1_kernel_size=3,
                                     normalize_feature=True, compute_dtype=jnp.float32)
    rng = np.random.RandomState(0)
    coords = np.unique(rng.randint(0, 20, size=(200, 4)).astype(np.int32), axis=0)
    coords[:, 0] = 0
    coords = np.unique(coords, axis=0)
    sv = jbuild.from_numpy(coords, np.ones((len(coords), 1), np.float32), 512)
    pyr = jax_build_pyramid(sv.coords, sv.num_valid, conv1_kernel_size=3,
                            level_capacity=(512, 256, 128, 64))
    variables = model.init(jax.random.PRNGKey(0), sv, pyr, jnp.zeros((1, *HW, 3)),
                           train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    # non-trivial running statistics: var leaves start at 1, mean leaves at 0
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim and v[0] == 1
                   else rng.randn(*v.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    port = build_model_from_config(threedmatch_config(**CFG))
    port.load_state_dict(state_dict_from_flax(variables))
    return model, variables, port


@pytest.fixture(scope="module")
def extracted(weights):
    """Every fragment through both bucketed extractors; the JAX escalations
    counted from its warnings."""
    model, variables, port = weights
    jext = jx.make_bucketed_extractor(model, variables, config=jax_config(**CFG),
                                      buckets=BUCKETS)
    text = tx.make_bucketed_extractor(port, config=threedmatch_config(**CFG), buckets=BUCKETS)
    image = np.random.RandomState(5).rand(1, *HW, 3).astype(np.float32)
    out = {}
    for name, (pts, _, _) in FRAGMENTS.items():
        raw, n = tx.pad_points_bucketed(pts, (4096,))
        handler = _Records()
        logging.getLogger().addHandler(handler)
        try:
            xj, fj = jext(raw, n, jnp.asarray(image))
        finally:
            logging.getLogger().removeHandler(handler)
        xt, ft = text(raw, n, image)
        out[name] = dict(jax=(xj, fj), port=(xt, ft), choice=text.last,
                         jax_escalations=sum("escalating" in m for m in handler.messages),
                         jax_extent=jx.pick_extent(raw, n, 0.025, jax_config(**CFG)))
    return out, jext, text, image


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("name", list(FRAGMENTS))
def test_bucketed_extractor_equals_jax(extracted, name):
    out = extracted[0][name]
    (xj, fj), (xt, ft) = out["jax"], out["port"]
    _, path, tried = FRAGMENTS[name]
    choice = out["choice"]
    assert ("exact" if choice.extent is None else "grid") == path
    assert choice.extent == out["jax_extent"]
    assert choice.tried == tried and choice.bucket == tried[-1]
    assert len(tried) - 1 == out["jax_escalations"]
    assert xt.shape == np.asarray(xj).shape == (choice.voxels, 3)
    np.testing.assert_array_equal(xt, np.asarray(xj))
    np.testing.assert_allclose(ft, np.asarray(fj), rtol=0, atol=DESC_ATOL)
    np.testing.assert_allclose(np.linalg.norm(ft, axis=1), 1.0, rtol=1e-5)


def test_overflow_of_the_largest_bucket_raises_where_jax_logs(extracted, caplog):
    _, jext, text, image = extracted
    raw, n = tx.pad_points_bucketed(OVERFLOW, (4096,))
    with caplog.at_level(logging.ERROR):
        jext(raw, n, jnp.asarray(image))
    assert any("truncated pyramid" in r.message for r in caplog.records)
    with pytest.raises(RuntimeError, match="overflow even the largest bucket 2048"):
        text(raw, n, image)


def test_make_extractor_equals_jax(weights, extracted):
    """The unbucketed extractor at a fixed pad, on the exact and the grid
    path, against the JAX package's and the bucketed rows."""
    model, variables, port = weights
    image = extracted[3]
    jext = jx.make_extractor(model, variables, config=jax_config(**CFG), n_pad=1024)
    text = tx.make_extractor(port, config=threedmatch_config(**CFG), n_pad=1024)
    raw, n = tx.pad_points_bucketed(FRAGMENTS["exact"][0], (4096,))
    xj, fj, nj = jext(raw, n, jnp.asarray(image))
    xt, ft, nt = text(raw, n, image)
    assert int(nt) == int(nj) == extracted[0]["exact"]["choice"].voxels
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=DESC_ATOL)
    # the grid path of the same fixed-pad extractor equals the bucketed rows
    raw, n = tx.pad_points_bucketed(FRAGMENTS["escalation"][0], (4096,))
    xt, ft, nt = tx.make_extractor(port, config=threedmatch_config(**CFG), n_pad=2048)(
        raw, n, image)
    xb, fb = extracted[0]["escalation"]["port"]
    np.testing.assert_array_equal(xt[:int(nt)].numpy(), xb)
    np.testing.assert_allclose(ft[:int(nt)].numpy(), fb, rtol=0, atol=DESC_ATOL)


def test_pick_extent_without_grid_maps_takes_the_exact_path():
    cfg = threedmatch_config(**CFG, use_grid_maps=False)
    raw, n = tx.pad_points_bucketed(FRAGMENTS["grid"][0], (4096,))
    assert tx.pick_extent(raw, n, 0.025, cfg) is None
    assert tx.pick_extent(raw, n, 0.025, threedmatch_config(**CFG)) == (64, 64, 64)
