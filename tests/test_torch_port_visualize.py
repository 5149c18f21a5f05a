"""Port parity, the visualizer: ``visualize_pair_registration`` against the
JAX package's on two fragments with images, the JAX draws of ``PRNGKey(0)``
injected (keypoint keys and RANSAC samples), the views it writes, the
correspondence view, and the projection and crop helpers of
``geom.image``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.geom import image as jimage
from imfnet_tpu.geom.ply import read_ply as jax_read_ply
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.utils import visualization as jvis

from imfnet_tpu_torch import cli
from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.eval.registration import make_pair_registration
from imfnet_tpu_torch.geom import image as pimage
from imfnet_tpu_torch.geom.ply import read_ply, write_ply
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.train.checkpoint import save_checkpoint
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.utils import visualization as pvis
from imfnet_tpu_torch.utils.flax_weights import flax_from_state_dict, state_dict_from_flax

from test_torch_port_model import _randomize
from test_torch_port_threedmatch import HYPO_BLOCK, METRIC_ATOL, jax_samples

HW = (24, 32)
CFG = dict(conv1_kernel_size=3, model_n_out=16, compute_dtype="float32", image_H=HW[0],
           image_W=HW[1], ransac_max_iteration=4096, grid_extent=(96, 96, 96))
NUM_KP = 1024      # below the 2 048 rows of these fragments (the JAX sampler needs it)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws_register(config):
    """A port ``register`` with the draws of the JAX visualizer's
    ``PRNGKey(0)``: split in three, uniform keys for both sides' keypoints,
    RANSAC samples from the third."""
    reg = make_pair_registration(
        num_keypoints=NUM_KP, voxel_size=config.voxel_size, ransac_n=config.ransac_n,
        num_hypotheses=config.ransac_max_iteration, inlier_thresh=config.inlier_thresh)

    def register(xyz0, f0, n0, xyz1, f1, n1, T_gt, cov):
        k0, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 3)
        u = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (xyz0.shape[0],))))
                  for k in (k0, k1))
        s = jax_samples(k2, min(n0, NUM_KP), config.ransac_max_iteration, HYPO_BLOCK,
                        config.ransac_n)
        return reg(xyz0, f0, n0, xyz1, f1, n1, T_gt, cov, keypoint_u=u,
                   samples=torch.from_numpy(s))

    return register


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Two 1 500-point fragments of one synthetic pair with their PNGs, and
    a ResUNetBN2C's weights on both sides."""
    root = tmp_path_factory.mktemp("vis")
    pair = synthetic_pair(np.random.RandomState(0), n_points=1500, extent=1.0, image_hw=HW)
    rng = np.random.RandomState(1)
    paths = []
    for k, xyz in enumerate((pair.xyz0, pair.xyz1)):
        write_ply(str(root / f"f{k}.ply"), xyz)
        pimage.save_image(str(root / f"f{k}.png"), rng.rand(*HW, 3))
        paths += [str(root / f"f{k}.ply"), str(root / f"f{k}.png")]
    torch.manual_seed(0)
    model = load_model("ResUNetBN2C")(out_channels=16, conv1_kernel_size=3,
                                      compute_dtype=torch.float32)
    variables = _randomize(flax_from_state_dict(model.state_dict()), np.random.RandomState(2))
    model.load_state_dict(state_dict_from_flax(variables))
    return dict(root=root, paths=paths, model=model.eval(), variables=variables, pair=pair)


def test_visualize_pair_registration_equals_jax(scene, tmp_path):
    jcfg, cfg = jax_config(**CFG), threedmatch_config(**CFG)
    jmodel = jax_load_model(jcfg.model)(in_channels=1, out_channels=16, conv1_kernel_size=3,
                                        compute_dtype=jnp.float32)
    jT, jfit = jvis.visualize_pair_registration(jmodel, scene["variables"], jcfg,
                                                *scene["paths"], str(tmp_path / "jax"),
                                                num_keypoints=NUM_KP)
    T, fit = pvis.visualize_pair_registration(scene["model"], cfg, *scene["paths"],
                                              str(tmp_path / "port"), num_keypoints=NUM_KP,
                                              register=jax_draws_register(cfg))
    # random weights register nothing; the same draws give the same pose
    assert fit == pytest.approx(jfit, abs=1e-6)
    np.testing.assert_allclose(T, jT, rtol=0, atol=METRIC_ATOL)
    before = read_ply(str(tmp_path / "port" / "before.ply"))
    jbefore = jax_read_ply(str(tmp_path / "jax" / "before.ply"))
    for k in before:
        np.testing.assert_array_equal(before[k], jbefore[k])
    after = read_ply(str(tmp_path / "port" / "after.ply"))
    jafter = jax_read_ply(str(tmp_path / "jax" / "after.ply"))
    np.testing.assert_array_equal(after["colors"], jafter["colors"])
    np.testing.assert_allclose(after["points"], jafter["points"], rtol=0, atol=1e-3)
    assert len(after["points"]) == len(scene["pair"].xyz0) + len(scene["pair"].xyz1)


def test_visualize_subcommand_on_the_cpu(scene, tmp_path, capsys, monkeypatch):
    """The command's 5 000 keypoints a side need larger fragments (6 240
    voxels); with the port's own draws (a generator seeded with 0) it prints
    the fitness and the pose and writes both views."""
    cfg = threedmatch_config(**{**CFG, "grid_extent": (256, 256, 256)})
    ckpt = save_checkpoint(str(tmp_path), "checkpoint", create_train_state(scene["model"], cfg, 1),
                           cfg, 1, 0.0, 1, cfg.best_val_metric)
    out = tmp_path / "views"
    pair = synthetic_pair(np.random.RandomState(4), n_points=8000, extent=2.0, image_hw=HW)
    p0, p1 = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    write_ply(p0, pair.xyz0)
    write_ply(p1, pair.xyz1)
    _, i0, _, i1 = scene["paths"]
    argv = ["visualize", "--checkpoint", ckpt, "--ply0", p0, "--image0", i0, "--ply1", p1,
            "--image1", i1, "--out-dir", str(out)]
    cli.main([*argv, "--device", "cpu"])
    text = capsys.readouterr().out
    fit = float(text.split("fitness ")[1].split(";")[0])
    assert 0.0 <= fit <= 1.0 and "[[" in text
    assert len(read_ply(str(out / "after.ply"))["points"]) == len(pair.xyz0) + len(pair.xyz1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


def test_correspondence_view_equals_jax(tmp_path):
    rng = np.random.RandomState(3)
    x0, x1 = rng.rand(50, 3).astype(np.float32), rng.rand(40, 3).astype(np.float32)
    pairs = np.stack([rng.randint(0, 50, 30), rng.randint(0, 40, 30)], 1)
    for correct in (None, rng.rand(30) > 0.5):
        pvis.save_correspondence_view(str(tmp_path / "p.ply"), x0, x1, pairs, correct)
        jvis.save_correspondence_view(str(tmp_path / "j.ply"), x0, x1, pairs, correct)
        a, b = read_ply(str(tmp_path / "p.ply")), jax_read_ply(str(tmp_path / "j.ply"))
        assert len(a["points"]) == 50 + 40 + 30 * 8
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projection_and_crop_helpers_equal_jax(seed):
    rng = np.random.RandomState(seed)
    K = np.array([[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1]])
    pts = rng.randn(500, 3) * [1.0, 0.8, 0.5] + [0, 0, 2.0]
    pts[:5, 2] = 0.0                                   # on the camera plane
    pts[5:10, 2] *= -1                                 # behind the camera
    np.testing.assert_array_equal(pimage.project_points(pts, K), jimage.project_points(pts, K))
    for i in (0, 7, 100):
        assert (pimage.point_to_pixel(pts[i], pts, K, 640, 480)
                == jimage.point_to_pixel(pts[i], pts, K, 640, 480))
    img = rng.rand(48, 64, 3)
    for u, v, size in ((0, 0, 16), (63, 47, 16), (30, 20, 100), (5, 40, 33)):
        np.testing.assert_array_equal(pimage.crop_around_pixel(img, u, v, size),
                                      jimage.crop_around_pixel(img, u, v, size))
    pose = np.eye(4)
    pose[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    pose[:3, 3] = rng.randn(3)
    world = pts @ pose[:3, :3].T + pose[:3, 3]
    crop = pimage.fragment_image_crop(world, pose, K, img, 24)
    assert crop.shape == (24, 24, 3)
    np.testing.assert_array_equal(crop, jimage.fragment_image_crop(world, pose, K, img, 24))
