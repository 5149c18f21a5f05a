"""Port parity, the evaluation side's compiled programs: ICP, the two
extractors, eval-kitti's pair (forward and registration in one program) and
eval-3dmatch's register, as the JAX package jits them and the port replays
them as CUDA graphs (``utils.graphs.jit``).

On the CPU each runs its graph's structure eagerly: draws made outside in
the eager order and passed in, the stages split where the host reads
(the extractor's voxel count and ``coarse_levels_fit``). That structure is
held bit for bit to the port's eager functions and, with the JAX package's
draws injected, to the JAX functions at the tolerances the existing parity
tests state. Descriptors here are 16-d (``model_n_out`` 16), a width kernel B
serves on the card since it takes any D. The launch counters' per-thread
tally, which lets a producer thread capture beside the main thread, is
checked too. The replays on the card are in
``tests/test_torch_port_graphs_eval_card.py``.
"""
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.config import threedmatch_config as jax_config
from imfnet_tpu.data import collate as jcollate
from imfnet_tpu.eval import extract as jx
from imfnet_tpu.eval import registration as jreg
from imfnet_tpu.match.icp import icp_point_to_point as jax_icp
from imfnet_tpu.train import step as jstep

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.collate import collate_pairs
from imfnet_tpu_torch.eval import extract as tx
from imfnet_tpu_torch.eval.kitti import make_eval_pair, make_pair_register
from imfnet_tpu_torch.eval.registration import make_keypoint_registration
from imfnet_tpu_torch.eval.threedmatch import make_scene_register
from imfnet_tpu_torch.match.icp import icp_graphed, icp_loop, icp_point_to_point
from imfnet_tpu_torch.match.nn_kernel import flash_nn
from imfnet_tpu_torch.sparse.conv_kernel import gather_gemm
from imfnet_tpu_torch.train.step import forward_pair
from imfnet_tpu_torch.train.validate import make_graphed_val_step, make_val_step
from imfnet_tpu_torch.utils import graphs, launches

from test_torch_port_extract import CFG as EXTRACT_CFG
from test_torch_port_extract import DESC_ATOL, FRAGMENTS, weights  # noqa: F401
from test_torch_port_graphs import _port_model, jax_setup  # noqa: F401
from test_torch_port_graphs_card import N_PAD, SMALL, _model, _val_pair
from test_torch_port_kitti import ICP_ATOL
from test_torch_port_kitti_eval import ATOL as KITTI_ATOL
from test_torch_port_threedmatch import HYPO_BLOCK, METRIC_ATOL, RRE_ATOL, jax_samples

RANSAC = 8192   # hypotheses: one block of HYPO_BLOCK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- ICP ---------------------------------------------------------------------

def _icp_case(seed=0, n=1500, m=2000):
    """tests/test_torch_port_kitti.py's clouds: one cloud under a small
    motion with 5 mm of noise, padded to a power of two."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(max(n, m), 3) * np.array([10.0, 10.0, 2.0])).astype(np.float32)
    a = 0.05
    T = np.array([[np.cos(a), -np.sin(a), 0, 0.1], [np.sin(a), np.cos(a), 0, -0.05],
                  [0, 0, 1, 0.02], [0, 0, 0, 1]])
    src = (base[:n] - T[:3, 3]) @ T[:3, :3] + rng.randn(n, 3) * 0.005
    n_pad = 1 << int(np.ceil(np.log2(max(n, m))))
    sp, dp = np.zeros((n_pad, 3), np.float32), np.zeros((n_pad, 3), np.float32)
    sp[:n], dp[:m] = src, base[:m]
    return sp, dp, np.arange(n_pad) < n, np.arange(n_pad) < m


def test_icp_loop_equals_the_eager_icp_and_jax():
    """The graph's body from the initial pose equals icp_point_to_point
    (eager on the CPU, whichever ``graphed``) bit for bit, and the JAX ICP
    within ICP_ATOL."""
    sp, dp, sv, dv = _icp_case()
    args = [torch.from_numpy(a) for a in (sp, dp, sv, dv)]
    replays = icp_graphed.replays
    want = icp_point_to_point(*args, torch.eye(4), 0.2, iters=30, graphed=False)
    got = icp_point_to_point(*args, torch.eye(4), 0.2, iters=30)
    body = icp_loop(*args, torch.eye(4), 0.2, 30)
    assert icp_graphed.replays == replays      # no graph on the CPU
    assert torch.equal(got, want) and torch.equal(body, want)
    ref = np.asarray(jax_icp(*(jnp.asarray(a) for a in (sp, dp, sv, dv)), jnp.eye(4), 0.2,
                             iters=30))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ICP_ATOL)


# ---- the extractors ----------------------------------------------------------

@pytest.mark.parametrize("name", list(FRAGMENTS))
def test_bucketed_stages_equal_the_one_program_extractor_bit_for_bit(weights, name):  # noqa: F811
    """The bucketed extractor's three programs (quantize at the largest
    bucket, then pyramid and forward at the bucket it settles on, the host
    reads between them) equal make_extractor's one program at that bucket,
    bit for bit on the valid rows; both equal the JAX bucketed extractor
    within DESC_ATOL."""
    model, variables, port = weights
    cfg = threedmatch_config(**EXTRACT_CFG)
    buckets = (512, 1024, 2048)
    staged = tx.make_bucketed_extractor(port, config=cfg, buckets=buckets)
    assert staged.graphed is None
    image = np.random.RandomState(5).rand(1, 24, 32, 3).astype(np.float32)
    raw, n = tx.pad_points_bucketed(FRAGMENTS[name][0], (4096,))
    xs, fs = staged(raw, n, image)
    choice = staged.last
    one = tx.make_extractor(port, config=cfg, n_pad=choice.bucket)
    assert one.graphed is None
    xo, fo, no = one(raw, n, image)
    assert int(no) == choice.voxels and bool(one.fits)
    np.testing.assert_array_equal(xs, xo[:choice.voxels].numpy())
    np.testing.assert_array_equal(fs, fo[:choice.voxels].numpy())
    jext = jx.make_bucketed_extractor(model, variables, config=jax_config(**EXTRACT_CFG),
                                      buckets=buckets)
    xj, fj = jext(raw, n, jnp.asarray(image))
    np.testing.assert_array_equal(xs, np.asarray(xj))
    np.testing.assert_allclose(fs, np.asarray(fj), rtol=0, atol=DESC_ATOL)


# ---- eval-kitti's pair ---------------------------------------------------------

def _kitti_cfg(jax_setup):  # noqa: F811
    return jax_setup["cfg"].replace(batch_size=1, ransac_max_iteration=RANSAC)


def test_eval_pair_with_outside_draws_equals_the_eager_pair_bit_for_bit(jax_setup):  # noqa: F811
    """make_eval_pair's program (both forwards, then the registration, its
    draws made first from the generator seeded with the pair's index)
    against the eager evaluator's steps: forward_pair, then the pair
    registration drawing from that generator as it goes."""
    cfg = _kitti_cfg(jax_setup)
    model = _port_model(cfg, jax_setup["variables"]).eval()
    b = collate_pairs([_val_pair()], N_PAD, device="cpu")
    eval_pair = make_eval_pair(model, cfg)
    assert eval_pair.graphed is None
    for i in (0, 3):
        got = eval_pair(i, b)
        with torch.no_grad():
            f0, f1 = forward_pair(model, b, train=False, config=cfg)
        want = make_pair_register(cfg)(b.xyz0, f0, b.n0, b.xyz1, f1, b.n1, b.T_gt[0],
                                       torch.eye(6),
                                       generator=torch.Generator().manual_seed(i))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_eval_pair_matches_jax(jax_setup):  # noqa: F811
    """The JAX evaluator's pair program (imfnet_tpu/eval/kitti.py:45) with
    PRNGKey(i) against the port's given the same draws: the pose and RTE
    within tests/test_torch_port_kitti_eval.py's 1e-4, RRE within 0.1°."""
    cfg = _kitti_cfg(jax_setup)
    jcfg = jax_setup["jcfg"].replace(batch_size=1, ransac_max_iteration=RANSAC)
    v = jax_setup["variables"]
    pair = _val_pair()
    jb = jcollate.collate_pairs([jcollate.VoxelizedPair(**vars(pair))], N_PAD)
    b = collate_pairs([pair], N_PAD, device="cpu")
    key = jax.random.PRNGKey(2)
    register = jreg.make_pair_registration(
        num_keypoints=jcfg.max_points, voxel_size=jcfg.voxel_size, ransac_n=jcfg.ransac_n,
        num_hypotheses=jcfg.ransac_max_iteration, inlier_thresh=jcfg.inlier_thresh,
        distance_multiplier=1.0)

    @jax.jit
    def eval_pair(params, batch_stats, batch, key):   # as the JAX evaluator jits it
        f0, f1, _ = jstep.forward_pair(jax_setup["jmodel"], params, batch_stats, batch,
                                       train=False, config=jcfg)
        return register(key, batch.xyz0, f0, batch.n0, batch.xyz1, f1, batch.n1,
                        batch.T_gt[0], jnp.eye(6, dtype=jnp.float32))

    ref = eval_pair(v["params"], v["batch_stats"], jb, key)
    k0, k1, k2 = jax.random.split(key, 3)
    u0, u1 = (torch.from_numpy(np.array(jax.random.uniform(k, (N_PAD,)))) for k in (k0, k1))
    samples = jax_samples(k2, int(b.n0), RANSAC, HYPO_BLOCK, cfg.ransac_n)
    eval_pair = make_eval_pair(_port_model(cfg, v).eval(), cfg)
    got = eval_pair.body(b, torch.eye(6), u0, u1, torch.from_numpy(samples))
    np.testing.assert_allclose(got["transformation"].numpy(), np.asarray(ref["transformation"]),
                               rtol=0, atol=KITTI_ATOL)
    np.testing.assert_allclose(float(got["rte_raw"]), float(ref["rte_raw"]), rtol=0,
                               atol=KITTI_ATOL)
    np.testing.assert_allclose(float(got["rre_raw"]), float(ref["rre_raw"]), rtol=0,
                               atol=RRE_ATOL)
    assert bool(got["accepted"]) == bool(ref["accepted"])


# ---- eval-3dmatch's register ---------------------------------------------------

def _keypoint_case(d, seed=4):
    """Two 500-row keypoint sets of one cloud under a known pose, d-wide
    unit descriptors that identify the rows with noise, 420 and 380 valid
    rows; gt maps side 1 onto side 0, as gt.log does."""
    rng = np.random.RandomState(seed)
    n = 500
    xyz0 = (rng.rand(n, 3) * 2).astype(np.float32)
    ang = 0.3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    T[:3, 3] = [0.3, 0.1, -0.2]
    perm = rng.permutation(n)
    xyz1 = (xyz0[perm] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    f0 = rng.randn(n, d).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 = (f0[perm] + 0.05 * rng.randn(n, d)).astype(np.float32)
    ok0, ok1 = np.arange(n) < 420, np.arange(n) < 380
    return (xyz0, f0, ok0, xyz1, f1, ok1, np.linalg.inv(T).astype(np.float32),
            np.eye(6, dtype=np.float32))


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("d", [16, 32])
def test_scene_register_with_outside_samples_equals_the_eager_one(d, swap):
    """make_scene_register's program: RANSAC's uniforms drawn first from
    the generator seeded with the pair's index, then register_kp given
    them, against register_kp drawing from that generator itself: every
    metric bit for bit, at 16- and 32-d descriptors, either swap."""
    cfg = threedmatch_config(ransac_max_iteration=RANSAC)
    case = [torch.from_numpy(a) for a in _keypoint_case(d)]
    register_kp = make_keypoint_registration(voxel_size=cfg.voxel_size,
                                             ransac_n=cfg.ransac_n,
                                             num_hypotheses=RANSAC, inlier_thresh=0.1)
    k = 5
    samples = torch.rand(register_kp.sample_shape, generator=torch.Generator().manual_seed(k))
    got = register_kp(*case, samples=samples, swap=swap)
    want = make_scene_register(cfg, 0.1, device="cpu")(k, *case, swap=swap)
    assert make_scene_register(cfg, 0.1, device="cpu").graphed is None
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert bool(got["accepted"])


@pytest.mark.parametrize("swap", [False, True])
def test_scene_register_matches_jax_at_16_d(swap):
    """The JAX register_kp at 16-d descriptors, its RANSAC samples injected:
    tests/test_torch_port_threedmatch.py's tolerances."""
    cfg = threedmatch_config(ransac_max_iteration=RANSAC)
    case = _keypoint_case(16, seed=6)
    key = jax.random.PRNGKey(11)
    ref = jreg.make_keypoint_registration(voxel_size=cfg.voxel_size, ransac_n=cfg.ransac_n,
                                          num_hypotheses=RANSAC, inlier_thresh=0.1)(
        key, *(jnp.asarray(a) for a in case), swap=swap)
    n_valid = int(case[5 if swap else 2].sum())
    samples = jax_samples(key, n_valid, RANSAC, HYPO_BLOCK, cfg.ransac_n)
    got = make_keypoint_registration(voxel_size=cfg.voxel_size, ransac_n=cfg.ransac_n,
                                     num_hypotheses=RANSAC, inlier_thresh=0.1)(
        *(torch.from_numpy(a) for a in case), samples=torch.from_numpy(samples), swap=swap)
    np.testing.assert_allclose(got["transformation"].numpy(), np.asarray(ref["transformation"]),
                               rtol=0, atol=METRIC_ATOL)
    for k in ("rr", "rte", "ir", "num_inliers", "inlier_ratio_mutual"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=0, atol=METRIC_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["rre"]), float(ref["rre"]), rtol=0, atol=RRE_ATOL)


def test_validation_at_16_d_graph_structure_equals_the_plain_step():
    """model_n_out 16 through the graphed validation step's structure (its
    subsample draws made outside) against make_val_step, bit for bit."""
    cfg = threedmatch_config(**SMALL).replace(batch_size=1, val_subsample_size=512)
    assert cfg.model_n_out == 16
    b = collate_pairs([_val_pair()], N_PAD, device="cpu")
    model = _model(cfg).eval()
    want = make_val_step(model, cfg)(b, torch.Generator().manual_seed(2))
    got = make_graphed_val_step(model, cfg)(b, torch.Generator().manual_seed(2))
    assert all(torch.equal(want[k], got[k]) for k in want)


# ---- the launch counters beside other threads ----------------------------------

def test_a_capture_tallies_only_the_launches_on_its_stream(monkeypatch):
    """What is counted on a stream inside ``tallied`` (a capture) stays out
    of the counters, from whichever thread it comes (autograd's thread
    records a captured backward); launches on other streams meanwhile count
    as they happen. Each thread here launches on a stream of its own."""
    streams = threading.local()
    monkeypatch.setattr(launches, "_stream_key", lambda: getattr(streams, "key", "main"))
    before = (flash_nn.launches, gather_gemm.launches, gather_gemm.launches_tc)
    inside, go, done = threading.Event(), threading.Event(), threading.Event()
    tallies = {}

    def capturing():
        streams.key = "side"
        with launches.tallied("side") as tally:
            launches.count(flash_nn)
            launches.count(gather_gemm, "launches_tc")
            inside.set()
            go.wait(10)
            launches.count(flash_nn)
        tallies["capture"] = dict(tally)
        done.set()

    def backward_on_the_side_stream():
        streams.key = "side"
        launches.count(gather_gemm)

    t = threading.Thread(target=capturing)
    t.start()
    assert inside.wait(10)
    launches.count(flash_nn)                  # the main thread's stream, during the capture
    launches.count(gather_gemm)
    helper = threading.Thread(target=backward_on_the_side_stream)
    helper.start()
    helper.join(10)
    go.set()
    assert done.wait(10)
    t.join()
    assert tallies["capture"] == {(flash_nn, "launches"): 2, (gather_gemm, "launches_tc"): 1,
                                  (gather_gemm, "launches"): 1}
    assert (flash_nn.launches, gather_gemm.launches) == (before[0] + 1, before[1] + 1)
    launches.add(tallies["capture"])          # one replay
    assert graphs._read_counters()[4] == before[0] + 3
    assert (gather_gemm.launches, gather_gemm.launches_tc) == (before[1] + 2, before[2] + 1)
    flash_nn.launches, gather_gemm.launches, gather_gemm.launches_tc = before
