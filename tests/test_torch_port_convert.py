"""Port parity, reference-weight conversion: MinkowskiEngine's offset order
and the permutation onto the port's, a reference-layout ``state_dict``
(``test_torch_convert._emit_torch_dict``) through the port's converter
against the JAX converter followed by ``state_dict_from_flax`` (exactly,
tensor for tensor), torchvision's ResNet-34 into the trunk, and
``convert-imfnet`` → ``generate-desc`` on the CPU against the JAX package's
descriptors with its own converted weights."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.cli import _load_model_and_vars as jax_load_model_and_vars
from imfnet_tpu.cli import main as jax_main
from imfnet_tpu.eval.extract import make_bucketed_extractor as jax_bucketed_extractor
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.build import from_numpy
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from imfnet_tpu.utils import torch_weights as jtw

from imfnet_tpu_torch import cli
from imfnet_tpu_torch.eval import threedmatch
from imfnet_tpu_torch.eval.extract import pad_points_bucketed
from imfnet_tpu_torch.geom.image import save_image
from imfnet_tpu_torch.geom.ply import write_ply
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.models.resnet import ResNetTrunk
from imfnet_tpu_torch.train.checkpoint import load_model_from_checkpoint
from imfnet_tpu_torch.utils import torch_weights as ptw
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

from test_models import make_cloud
from test_torch_convert import _emit_torch_dict
from test_torch_port_model import _randomize

SCENE = "7-scenes-redkitchen"
BF16_ATOL = 1e-2   # bf16 descriptors: the JAX package's CPU convs round per offset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_me_offsets_and_permutations_equal_jax(k):
    np.testing.assert_array_equal(ptw.me_kernel_region_offsets(k),
                                  jtw.me_kernel_region_offsets(k))
    for reverse in (False, True):
        p = ptw.me_offset_permutation(k, reverse=reverse)
        np.testing.assert_array_equal(p, jtw.me_offset_permutation(k, reverse=reverse))
        assert sorted(p) == list(range(k ** 3))


@pytest.fixture(scope="module")
def variables():
    """Flax variables of a ResUNetBN2C (conv1 k3): random kernels from the
    initializer, random norm statistics and affine terms, so that a swapped
    or transposed tensor shows."""
    model = jax_load_model("ResUNetBN2C")(in_channels=1, out_channels=32, conv1_kernel_size=3,
                                          compute_dtype=jnp.float32)
    coords = make_cloud(np.random.RandomState(0), 150, 0, span=10)
    sv = from_numpy(coords, np.ones((len(coords), 1), np.float32), 256)
    pyr = jax_build_pyramid(sv.coords, sv.num_valid, conv1_kernel_size=3,
                            level_capacity=(256, 128, 64, 64))
    image = jnp.zeros((1, 24, 32, 3), jnp.float32)
    v = jax.jit(lambda s, p, i: model.init(jax.random.PRNGKey(0), s, p, i, train=False))(
        sv, pyr, image)
    return _randomize(jax.tree_util.tree_map(np.asarray, dict(v)), np.random.RandomState(1))


@pytest.mark.parametrize("fusion_prefix", ["attention_fusion", "perceiver_io"])
def test_converter_equals_jax_then_flax_weights(variables, fusion_prefix):
    sd = _emit_torch_dict(variables, 3)
    sd = {(fusion_prefix + k[len("attention_fusion"):]
           if k.startswith("attention_fusion.") else k): torch.from_numpy(v.copy())
          for k, v in sd.items()}
    got = ptw.convert_imfnet_torch(sd, conv1_kernel_size=3)
    want = state_dict_from_flax(jtw.convert_imfnet_torch(
        _emit_torch_dict(variables, 3), conv1_kernel_size=3))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    # and the converted tensors are exactly the ones the model was made of
    assert all(torch.equal(got[n], w) for n, w in state_dict_from_flax(variables).items())
    model = load_model("ResUNetBN2C")(conv1_kernel_size=3, compute_dtype=torch.float32)
    model.load_state_dict(got, strict=True)
    with pytest.raises(KeyError, match="missing checkpoint key: final.bias"):
        ptw.convert_imfnet_torch({k: v for k, v in sd.items() if k != "final.bias"},
                                 conv1_kernel_size=3)


def _torchvision_resnet34(rng):
    """A random state_dict with torchvision resnet34's keys and shapes of the
    layers the trunk keeps, plus layer3 and fc, which it drops."""
    trunk = ResNetTrunk(compute_dtype=torch.float32)
    sd = {}
    for k, v in trunk.state_dict().items():
        mod, _, leaf = k.rpartition(".")
        parts = mod.split(".")
        if parts[0].startswith("layer"):
            layer, block = parts[0].split("_block")
            sub = {"down_conv": "downsample.0", "down_bn": "downsample.1"}.get(parts[1], parts[1])
            mod = f"{layer}.{block}.{sub}"
        sd[f"{mod}.{leaf}"] = (torch.tensor(rng.randn(*v.shape).astype(np.float32))
                               if v.is_floating_point() else torch.tensor(7))
    sd["layer3.0.conv1.weight"] = torch.zeros(256, 128, 3, 3)
    sd["fc.weight"] = torch.zeros(1000, 512)
    return sd


def test_resnet34_conversion_equals_jax(tmp_path):
    sd = _torchvision_resnet34(np.random.RandomState(2))
    got = ptw.convert_resnet34_torch(sd)
    j = jtw.convert_resnet34_torch(sd)
    want = {k[len("img_encoder."):]: v for k, v in state_dict_from_flax(
        {"params": {"img_encoder": j["params"]},
         "batch_stats": {"img_encoder": j["batch_stats"]}}).items()}
    assert set(got) == set(want) == set(ResNetTrunk().state_dict())
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    torch.save(sd, tmp_path / "resnet34.pth")
    model = load_model("ResUNetBN2C")(conv1_kernel_size=3, compute_dtype=torch.float32)
    assert ptw.load_pretrained_resnet34(model, str(tmp_path / "resnet34.pth")) is model
    assert torch.equal(model.img_encoder.layer2_block0.down_conv.weight,
                       sd["layer2.0.downsample.0.weight"])


def test_convert_imfnet_then_generate_desc_equals_jax(variables, tmp_path, monkeypatch, capsys):
    """A reference `.pth` (state_dict + embedded config) → both packages'
    convert-imfnet; the port's checkpoint then gives generate-desc
    descriptors bit-equal to those of the original weights, and within the
    bf16 gate of the JAX package's extractor with its converted weights."""
    sd = {k: torch.from_numpy(v.copy()) for k, v in _emit_torch_dict(variables, 3).items()}
    pth = tmp_path / "imfnet.pth"
    torch.save({"state_dict": sd,
                "config": {"model": "ResUNetBN2C", "model_n_out": 32, "conv1_kernel_size": 3,
                           "normalize_feature": True, "voxel_size": 0.025},
                "epoch": 17, "best_val": 0.95, "best_val_epoch": 15,
                "best_val_metric": "feat_match_ratio"}, str(pth))
    jax_main(["convert-imfnet", "--pth", str(pth), "--out", str(tmp_path / "jax_ckpt")])
    cli.main(["convert-imfnet", "--pth", str(pth), "--out", str(tmp_path / "ckpt"),
              "--device", "cpu"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert out[1].pop("out") == str(tmp_path / "ckpt")
    assert out[0].pop("out") == str(tmp_path / "jax_ckpt")
    assert out[0] == out[1] and out[1]["conv1_kernel_size"] == 3
    with open(tmp_path / "jax_ckpt" / "meta.json") as f:
        jmeta = json.load(f)
    with open(tmp_path / "ckpt" / "meta.json") as f:
        meta = json.load(f)
    assert set(meta) == set(jmeta) and meta["config"] == jmeta["config"]
    assert meta["epoch"] == 17 and meta["converted_from"] == str(pth)

    # the original weights as a port checkpoint of the same config
    model, config = load_model_from_checkpoint(str(tmp_path / "ckpt"), "cpu")
    assert config.model == "ResUNetBN2C" and config.compute_dtype == "bfloat16"
    os.makedirs(tmp_path / "orig")
    torch.save({"model": state_dict_from_flax(variables)}, tmp_path / "orig" / "state.pt")
    with open(tmp_path / "orig" / "meta.json", "w") as f:
        json.dump(meta, f)

    rng = np.random.RandomState(5)
    pts = (rng.rand(2000, 3) * [1.2, 1.0, 0.05]).astype(np.float32)   # a slab
    image = rng.rand(config.image_H, config.image_W, 3).astype(np.float32)
    scene = tmp_path / "pcloud" / SCENE / "seq-01"
    os.makedirs(scene)
    write_ply(str(scene / "cloud_bin_0.ply"), pts)
    save_image(str(scene / "cloud_bin_0_0.png"), image)
    monkeypatch.setattr(threedmatch, "TEST_SCENE_NAMES", [SCENE])
    desc = {}
    for name in ("ckpt", "orig"):
        cli.main(["generate-desc", "--checkpoint", str(tmp_path / name), "--pcloud-root",
                  str(tmp_path / "pcloud"), "--out-root", str(tmp_path / f"desc_{name}"),
                  "--device", "cpu"])
        desc[name] = np.load(tmp_path / f"desc_{name}" / SCENE / "seq-01" / "cloud_bin_0.npz")
    np.testing.assert_array_equal(desc["ckpt"]["xyz"], desc["orig"]["xyz"])
    np.testing.assert_array_equal(desc["ckpt"]["feature"], desc["orig"]["feature"])

    jmodel, jvars, jconfig = jax_load_model_and_vars(str(tmp_path / "jax_ckpt"))
    extract = jax_bucketed_extractor(jmodel, jvars, config=jconfig, buckets=(2048,))
    raw, n_raw = pad_points_bucketed(pts)
    from imfnet_tpu.geom.image import load_image, process_image
    img = process_image(load_image(str(scene / "cloud_bin_0_0.png")),
                        jconfig.image_H, jconfig.image_W)
    jxyz, jfeat = extract(raw, n_raw, jnp.asarray(img[None]))
    np.testing.assert_array_equal(desc["ckpt"]["xyz"], np.asarray(jxyz))
    got, want = desc["ckpt"]["feature"], np.asarray(jfeat)
    assert np.isfinite(got).all() and len(got) > 1000
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    assert np.min(np.sum(got * want, axis=1)) > 0.999
