"""Port parity, ``cli dam`` on the CPU against the JAX command: the same
fragment PLY, PNG and weights, the files compared. The JAX command's two
attribution functions run jitted (the same functions; eagerly the command
takes over a minute on a CPU). The weights are the port's, carried to flax by
``flax_from_state_dict`` with randomized norm statistics."""
import json
import os

import numpy as np
import pytest
import torch
from flax import serialization

import imfnet_tpu.dam.dam as jdam
from imfnet_tpu.cli import main as jax_main
from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.geom.ply import read_ply as jax_read_ply

from imfnet_tpu_torch import cli
from imfnet_tpu_torch.data.synthetic import synthetic_pair
from imfnet_tpu_torch.geom.image import load_image, save_image
from imfnet_tpu_torch.geom.ply import read_ply, write_ply
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.utils.flax_weights import flax_from_state_dict, state_dict_from_flax

from test_torch_port_dam import CFG, HW, TARGET, _jit, _one_torch_thread  # noqa: F401
from test_torch_port_model import _randomize

_DAM, _IMG = jdam.descriptor_activation_map, jdam.image_activation_map


def _checkpoints(root, cfg, variables):
    """The same weights and config as a JAX checkpoint (flax msgpack) and
    as a port checkpoint (``state.pt``)."""
    meta = dict(epoch=1, best_val=0.0, best_val_epoch=1, best_val_metric="feat_match_ratio",
                config=json.loads(cfg.to_json()), format_version=1)
    for name in ("jax", "port"):
        os.makedirs(root / name)
        with open(root / name / "meta.json", "w") as f:
            json.dump(meta, f)
    with open(root / "jax" / "state.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"params": variables["params"], "batch_stats": variables["batch_stats"]}))
    torch.save({"model": state_dict_from_flax(variables)}, root / "port" / "state.pt")
    return str(root / "jax"), str(root / "port")


def test_cli_dam_equals_the_jax_command(tmp_path, monkeypatch):
    """The two commands on one fragment PLY and PNG: the same points in the
    PLY, colours within 2e-3 (they rescale weights held to 1e-4 of their
    largest value), the overlay within two levels of 255."""
    torch.manual_seed(0)
    model = load_model("ResUNetBN2C")(out_channels=8, conv1_kernel_size=3)
    variables = _randomize(flax_from_state_dict(model.state_dict()), np.random.RandomState(2))
    jck, pck = _checkpoints(tmp_path, jax_config(**CFG), variables)
    pair = synthetic_pair(np.random.RandomState(0), n_points=600, extent=0.6, image_hw=HW)
    write_ply(str(tmp_path / "f.ply"), pair.xyz0)
    save_image(str(tmp_path / "f.png"), np.random.RandomState(1).rand(*HW, 3))
    monkeypatch.setattr(jdam, "descriptor_activation_map",
                        lambda m, v, sv, p, i, t: _jit(_DAM, m, t)(v, sv, p, i))
    monkeypatch.setattr(jdam, "image_activation_map",
                        lambda m, v, sv, p, i, t: _jit(_IMG, m, t)(v, sv, p, i))
    args = ["--ply", str(tmp_path / "f.ply"), "--image", str(tmp_path / "f.png"),
            "--point", str(TARGET)]
    jax_main(["dam", "--checkpoint", jck, *args, "--out", str(tmp_path / "j.ply"),
              "--image-out", str(tmp_path / "j.png")])
    cli.main(["dam", "--checkpoint", pck, *args, "--out", str(tmp_path / "p.ply"),
              "--image-out", str(tmp_path / "p.png"), "--device", "cpu"])
    a, b = read_ply(str(tmp_path / "p.ply")), jax_read_ply(str(tmp_path / "j.ply"))
    assert len(a["points"]) > 400
    np.testing.assert_array_equal(a["points"], b["points"])
    np.testing.assert_allclose(a["colors"], b["colors"], rtol=0, atol=2e-3)
    pa, pb = load_image(str(tmp_path / "p.png")), load_image(str(tmp_path / "j.png"))
    assert pa.shape == HW + (3,)
    np.testing.assert_allclose(pa, pb, rtol=0, atol=2 / 255 + 1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["dam", "--checkpoint", pck, *args, "--out", str(tmp_path / "x.ply")])


