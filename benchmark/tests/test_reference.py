"""The plain reference against the program's CPU path at small sizes (the
program in float32 where the comparison is of arithmetic, not rounding)."""
import numpy as np
import pytest
import torch

from benchlib import weights
from benchlib.program import program_config
from conftest import small_cell
from reference import model as ref_model
from reference import registration as ref_reg
from reference import train as ref_train
from reference import voxels as ref_vox
from reference.precision import Precision
from traffic import surface

SEED = (1 << 31) + 99


def _cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * np.array([0.6, 0.5, 0.4])).astype(np.float32)


def _port_model(cfg, P, dtype=torch.float32):
    from imfnet_tpu_torch.models import load_model
    model = load_model(cfg.model)(in_channels=1, out_channels=cfg.model_n_out,
                                  conv1_kernel_size=cfg.conv1_kernel_size,
                                  normalize_feature=True, compute_dtype=dtype,
                                  conv1_occupancy=True)
    model.load_state_dict(P)
    return model.eval()


def test_weights_name_every_parameter_and_buffer_of_the_program():
    from imfnet_tpu_torch.pipeline import init_model
    from imfnet_tpu_torch.train.trainer import build_model_from_config

    cell = small_cell("3dmatch-pair")
    cfg = program_config(cell.config)
    P = weights.make(ref_model.param_specs(cell.config["model"]), SEED, "cpu")
    for model in (init_model(cfg), build_model_from_config(cfg)):
        sd = model.state_dict()
        assert set(sd) == set(P)
        assert all(sd[k].shape == P[k].shape and sd[k].dtype == P[k].dtype for k in sd)
    again = weights.make(ref_model.param_specs(cell.config["model"]), SEED, "cpu")
    assert all(torch.equal(P[k], again[k]) for k in P)


def test_voxels_and_maps_equal_the_programs():
    from imfnet_tpu_torch.sparse.grid import GridSpec, quantize_grid
    from imfnet_tpu_torch.sparse.kernel_map import build_pyramid

    xyz = torch.from_numpy(np.concatenate([_cloud(seed=1), _cloud(seed=2) + 0.3]))
    batch = torch.cat([torch.zeros(3000, dtype=torch.long), torch.ones(3000, dtype=torch.long)])
    coords, first = ref_vox.voxelize(xyz, batch, 0.025, (256, 256, 256))
    ones = torch.ones((len(xyz), 1))
    sv, _, xyz_down = quantize_grid(xyz, ones, torch.ones(len(xyz), dtype=torch.bool), 0.025,
                                    8192, GridSpec((256, 256, 256), 2), batch_index=batch)
    n = int(sv.num_valid)
    assert torch.equal(sv.coords[:n].long(), coords)
    assert torch.equal(xyz_down[:n], xyz[first])
    pyr = build_pyramid(sv.coords, sv.num_valid, level_capacity=(8192, 4096, 2048, 1024))
    ref = ref_vox.pyramid(coords)
    for i in range(4):
        nv = int(pyr.levels[i].num_valid)
        assert torch.equal(pyr.levels[i].coords[:nv].long(), ref.tables[i])
        assert torch.equal(pyr.levels[i].k3_same[:nv].long(), ref.same[i])
        if i:
            assert torch.equal(pyr.levels[i].down[:nv].long(), ref.down[i])
        if i < 3:
            assert torch.equal(pyr.levels[i].up[:nv].long(), ref.up[i])
    assert torch.equal(pyr.k5_l0[:n].long(), ref.conv1)


def test_descriptors_equal_the_programs_in_float32():
    from imfnet_tpu_torch.sparse.coords import SparseVoxels
    from imfnet_tpu_torch.sparse.kernel_map import build_pyramid

    cell = small_cell("3dmatch-pair")
    m = cell.config["model"]
    cfg = program_config(cell.config)
    P = weights.make(ref_model.param_specs(m), SEED, "cpu")
    xyz = torch.from_numpy(np.concatenate([_cloud(seed=3), _cloud(seed=4) + 0.2]))
    batch = torch.cat([torch.zeros(3000, dtype=torch.long), torch.ones(3000, dtype=torch.long)])
    coords, _ = ref_vox.voxelize(xyz, batch, 0.025)
    images = torch.rand((2, 120, 160, 3), generator=torch.Generator().manual_seed(0))
    n_pad = 8192
    c = torch.full((n_pad, 4), -(1 << 20), dtype=torch.int32)
    c[:len(coords)] = coords.int()
    nv = torch.tensor(len(coords), dtype=torch.int32)
    pyr = build_pyramid(c, nv, level_capacity=(8192, 4096, 2048, 1024))
    sv = SparseVoxels(c, torch.ones((n_pad, 1)), nv)
    with torch.no_grad():
        port = _port_model(cfg, P)(sv, pyr, images)[:len(coords)]
    ref = ref_model.descriptors(P, ref_vox.pyramid(coords), images, m, Precision("f32"))
    assert (port - ref).norm(dim=1).max() < 1e-4


def test_ransac_equals_the_programs_on_the_same_draws():
    from imfnet_tpu_torch.match.ransac import ransac_registration

    g = torch.Generator().manual_seed(5)
    src = torch.rand((400, 3), generator=g)
    R = torch.tensor(surface.rotation(np.array([0.2, 1.0, 0.3]), 0.7), dtype=torch.float32)
    dst = src @ R.T + 0.1
    dst[200:] = torch.rand((200, 3), generator=g)          # half are outliers
    valid = torch.ones(400, dtype=torch.bool)
    valid[390:] = False
    u = torch.rand((2, 500, 3), generator=g)
    port = ransac_registration(src, dst, valid, 0.0375, num_hypotheses=1000, hypo_block=500,
                               samples=u).transformation
    ref = ref_reg.ransac(src, dst, valid, 0.0375, u)
    assert torch.allclose(port, ref, atol=1e-4)
    assert torch.equal(ref_reg.inliers(port, src, dst, valid, 0.0375),
                       ref_reg.inliers(ref, src, dst, valid, 0.0375))


def test_training_loss_equals_the_programs_in_float32():
    from imfnet_tpu_torch.data.collate import VoxelizedPair, collate_pairs
    from imfnet_tpu_torch.train.step import loss_draws, make_loss_fn
    from imfnet_tpu_torch.train.trainer import build_model_from_config

    cell = small_cell("3dmatch-train")
    m = cell.config["model"]
    cfg = program_config(cell.config).replace(compute_dtype="float32", max_points=8192)
    P = weights.make(ref_model.param_specs(m), SEED, "cpu")
    model = build_model_from_config(cfg)
    model.load_state_dict(P)
    rng = np.random.default_rng(0)
    group, raw = [], []
    for k in range(2):
        x0 = _cloud(2500, seed=10 + k)
        x1 = (x0 + 0.01).astype(np.float32)
        c0 = np.floor(x0 / np.float32(0.025)).astype(np.int32)
        c1 = np.floor(x1 / np.float32(0.025)).astype(np.int32)
        _, f0 = np.unique(c0, axis=0, return_index=True)
        _, f1 = np.unique(c1, axis=0, return_index=True)
        f0, f1 = np.sort(f0), np.sort(f1)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = 0.01
        img = [rng.random((120, 160, 3), dtype=np.float32) for _ in range(2)]
        group.append(VoxelizedPair(c0[f0], x0[f0], np.ones((len(f0), 1), np.float32),
                                   c1[f1], x1[f1], np.ones((len(f1), 1), np.float32),
                                   img[0], img[1], T))
    batch = collate_pairs(group, 8192, grid_extent=cfg.grid_extent, device="cpu")
    draws = loss_draws(cfg, batch, torch.Generator().manual_seed(1))
    port, _ = make_loss_fn(model, cfg, map_impl="search")(batch, None, draws)

    sides = []
    for s in (0, 1):
        n = int(getattr(batch, f"n{s}"))
        sides.append(ref_train.TrainSide(getattr(batch, f"coords{s}")[:n].long(),
                                         getattr(batch, f"xyz{s}")[:n],
                                         getattr(batch, f"image{s}"), 8192))
    bs = cfg.batch_size
    consts = {"radius": 0.0375, "num_pos": cfg.num_pos_per_batch * bs,
              "num_hn": cfg.num_hn_samples_per_batch * bs, "pos_thresh": cfg.pos_thresh,
              "neg_thresh": cfg.neg_thresh, "neg_weight": cfg.neg_weight}
    ref, _, _ = ref_train.loss(P, m, tuple(sides), batch.T_gt, draws, consts, Precision("f32"))
    assert float(port.detach()) == pytest.approx(float(ref.detach()), rel=1e-4)
