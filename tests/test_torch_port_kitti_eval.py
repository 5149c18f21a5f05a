"""Port parity, the KITTI evaluator: ``evaluate_kitti`` of both packages on
the synthetic odometry layout (``test_torch_port_kitti.write_kitti_root``)
with carried weights and the JAX draws of pair i (``PRNGKey(i)``: keypoint
keys and RANSAC samples) injected into the port."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import kitti_config as jax_kitti_config
from imfnet_tpu.data import datasets as jds
from imfnet_tpu.eval.kitti import evaluate_kitti as jax_evaluate_kitti
from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.sparse.coords import SparseVoxels
from imfnet_tpu.train.step import make_pyramid_fn

from imfnet_tpu_torch.config import kitti_config
from imfnet_tpu_torch.data import datasets as pds
from imfnet_tpu_torch.eval.kitti import evaluate_kitti
from imfnet_tpu_torch.eval.registration import make_pair_registration
from imfnet_tpu_torch.train.trainer import build_model_from_config
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

from test_torch_port_kitti import write_kitti_root
from test_torch_port_threedmatch import HYPO_BLOCK, RRE_ATOL, jax_samples

ATOL = 1e-4   # success rate and RTE: f32 fits over the same draws
CFG = dict(max_points=4096, kitti_max_time_diff=3, ransac_max_iteration=8192,
           compute_dtype="float32", conv1_kernel_size=3, model_n_out=16, batch_size=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws_register(config):
    """register(i, batch, f0, f1) of the port's evaluator with the draws the
    JAX evaluator makes for pair i: PRNGKey(i) split in three, uniform keys
    for both sides' keypoints, RANSAC samples from the third."""
    register_pair = make_pair_registration(
        num_keypoints=config.max_points, voxel_size=config.voxel_size,
        ransac_n=config.ransac_n, num_hypotheses=config.ransac_max_iteration,
        inlier_thresh=config.inlier_thresh, distance_multiplier=1.0)

    def register(i, batch, f0, f1):
        k0, k1, k2 = jax.random.split(jax.random.PRNGKey(i), 3)
        n = batch.xyz0.shape[0]
        u = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (n,)))) for k in (k0, k1))
        s = jax_samples(k2, min(int(batch.n0), config.max_points),
                        config.ransac_max_iteration, HYPO_BLOCK, config.ransac_n)
        return register_pair(batch.xyz0, f0, batch.n0, batch.xyz1, f1, batch.n1,
                             batch.T_gt[0], torch.eye(6), keypoint_u=u,
                             samples=torch.from_numpy(s))

    return register


def test_evaluate_kitti_equals_jax(tmp_path, monkeypatch):
    root = write_kitti_root(tmp_path)
    for mod in (jds, pds):
        monkeypatch.setitem(mod.KITTIPairDataset.DATA_FILES, "test", str(root / "test_list.txt"))
    # one ICP cache: the port reads the ground truth the JAX dataset refined
    # (test_torch_port_kitti.py holds the two refinements to each other)
    jc = jax_kitti_config(kitti_root=str(root), **CFG)
    pc = kitti_config(kitti_root=str(root), **CFG)
    jloader = jds.PairLoader(jds.KITTIPairDataset("test", jc, random_rotation=False,
                                                  random_scale=False),
                             1, jc.max_points, shuffle=False)
    ploader = pds.PairLoader(pds.KITTIPairDataset("test", pc, random_rotation=False,
                                                  random_scale=False, icp_device="cpu"),
                             1, pc.max_points, shuffle=False, grid_extent=pc.grid_extent)

    model = jax_load_model(jc.model)(in_channels=1, out_channels=16, conv1_kernel_size=3,
                                     normalize_feature=True, compute_dtype=jnp.float32)
    batch = next(iter(jloader))
    pyr = make_pyramid_fn(jc, jc.max_points, 1)(batch.coords0, batch.n0)
    variables = model.init(jax.random.PRNGKey(0), SparseVoxels(batch.coords0, batch.feats0,
                                                               batch.n0),
                           pyr, batch.image0, train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    want = jax_evaluate_kitti(model, variables, jc, jloader)

    port = build_model_from_config(pc)
    port.load_state_dict(state_dict_from_flax(variables))
    got = evaluate_kitti(port, pc, ploader, register=jax_draws_register(pc))
    assert set(got) == set(want)
    assert got["num_pairs"] == want["num_pairs"] == 2
    assert got["failed_loads"] == want["failed_loads"] == 0
    assert got["success_rate"] == pytest.approx(want["success_rate"], abs=ATOL)
    assert got["success_rate"] >= 0.5
    assert got["rte"] == pytest.approx(want["rte"], abs=ATOL)
    assert got["rre"] == pytest.approx(want["rre"], abs=RRE_ATOL)

    # the port's own draws (generator seeded with the pair index) register
    # the pairs too, and with the occupancy conv1 of the inference model
    fast = build_model_from_config(pc, eval_fast=True)
    fast.load_state_dict(state_dict_from_flax(variables))
    own = evaluate_kitti(fast, pc, ploader)
    assert own["num_pairs"] == 2 and own["success_rate"] >= 0.5
    # two devices need the mesh of a rank (tests/test_torch_port_parallel_eval.py)
    with pytest.raises(ValueError, match="ranks"):
        evaluate_kitti(fast, pc, ploader, num_devices=2)
