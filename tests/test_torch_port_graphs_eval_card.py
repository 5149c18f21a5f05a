"""The evaluation side's compiled programs on the card (``cuda`` marker;
each test skips without one): ICP, both extractors, eval-kitti's pair and
eval-3dmatch's register replayed as CUDA graphs (``utils.graphs.jit``)
against their eager calls bit for bit, the kernel launches a replay counts
against an eager call's, ICP captured and replayed in a producer thread
beside the main thread's graphs, and ``cli train --model-n-out 16`` on the
card through a validation step (kernel B at a width of its chunk fold). The
file imports no JAX; ``tests/test_torch_port_graphs_eval.py`` holds the CPU
side.

    python3 -m pytest tests/test_torch_port_graphs_eval_card.py -q -p no:cacheprovider
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from imfnet_tpu_torch import cli
from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.collate import collate_pairs
from imfnet_tpu_torch.eval import extract as tx
from imfnet_tpu_torch.eval.kitti import make_eval_pair
from imfnet_tpu_torch.eval.registration import make_pair_registration
from imfnet_tpu_torch.eval.threedmatch import make_scene_register
from imfnet_tpu_torch.match.icp import icp_graphed, icp_point_to_point
from imfnet_tpu_torch.match.nn_kernel import flash_nn
from imfnet_tpu_torch.train.trainer import batch_to_device
from imfnet_tpu_torch.train.validate import make_graphed_val_step, make_val_step
from imfnet_tpu_torch.utils import graphs

from test_torch_port_graphs_card import N_PAD, REG, SMALL, _model, _reg_case, _val_pair

pytestmark = pytest.mark.cuda

CALLS = 3    # a warm-up, the capture, a replay


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured and replayed only on a card")
    return torch.device("cuda")


def _launches():
    return graphs._read_counters()


def _delta(fn):
    before = _launches()
    out = fn()
    torch.cuda.synchronize()
    return out, [a - b for a, b in zip(_launches(), before)]


def _icp_args(device, seed=0, n=3000, m=3500):
    """One cloud under a small motion with 5 mm of noise, padded to a power
    of two, as the KITTI dataset pads."""
    rng = np.random.RandomState(seed)
    base = (rng.rand(max(n, m), 3) * np.array([10.0, 10.0, 2.0])).astype(np.float32)
    a = 0.05
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    src = (base[:n] - [0.1, -0.05, 0.02]) @ R + rng.randn(n, 3) * 0.005
    n_pad = 1 << int(np.ceil(np.log2(max(n, m))))
    sp, dp = np.zeros((n_pad, 3), np.float32), np.zeros((n_pad, 3), np.float32)
    sp[:n], dp[:m] = src, base[:m]
    rows = np.arange(n_pad)
    return [torch.from_numpy(a).to(device) for a in (sp, dp, rows < n, rows < m)]


@pytest.mark.cuda
def test_replayed_icp_equals_the_eager_icp_bit_for_bit(card):
    args = _icp_args(card)
    want, eager = _delta(lambda: icp_point_to_point(*args, torch.eye(4), 0.2, graphed=False))
    captures = icp_graphed.captures
    for _ in range(CALLS):
        got, replay = _delta(lambda: icp_point_to_point(*args, torch.eye(4), 0.2))
        assert torch.equal(got, want)
    assert icp_graphed.captures == captures + 1
    assert replay == eager and replay[4] == 30     # kernel B once an iteration


@pytest.mark.cuda
@pytest.mark.parametrize("capturing", ["producer", "main"])
def test_icp_captures_in_a_producer_thread_beside_the_main_thread_s_graphs(card, capturing):
    """A producer thread runs ICP while the main thread runs a registration
    graph, both starting together: with "producer" the producer's ICP warms
    up, captures and replays while the main thread replays; with "main" the
    main thread's registration warms up and captures while the producer
    replays. Every result equals its eager call bit for bit, and the launch
    counters add up to the two threads' calls (a capture tallies its own
    thread's launches alone)."""
    n = {"producer": 5000, "main": 9000}[capturing]     # a signature of its own
    icp_args = _icp_args(card, seed=n, n=n, m=n)
    case = [torch.as_tensor(a).to(card) for a in _reg_case()]
    cov = torch.eye(6, device=card)
    register = make_pair_registration(**REG)

    def draws(i):
        return register.draws(case[0], case[3], torch.Generator(device=card).manual_seed(i))

    want_T = icp_point_to_point(*icp_args, torch.eye(4), 0.2, graphed=False)
    want_r = []
    for i in range(2):
        (u0, u1), s = draws(i)
        want_r.append(register.body(*case, cov, u0, u1, s))
    if capturing == "producer":     # the main thread only replays
        for i in range(2):
            register(*case, cov, generator=torch.Generator(device=card).manual_seed(i))
    else:                           # the producer only replays
        for _ in range(2):
            icp_point_to_point(*icp_args, torch.eye(4), 0.2)
    torch.cuda.synchronize()
    before = flash_nn.launches
    n_icp, n_reg = 4, 12
    results, errors = [], []
    start = threading.Barrier(2)

    def producer():
        try:
            start.wait(10)
            for _ in range(n_icp):
                results.append(icp_point_to_point(*icp_args, torch.eye(4), 0.2).cpu())
        except Exception as e:   # noqa: BLE001  (reported below)
            errors.append(e)

    t = threading.Thread(target=producer)
    t.start()
    start.wait(10)
    got_r = [register(*case, cov, generator=torch.Generator(device=card).manual_seed(i % 2))
             for i in range(n_reg)]
    t.join(120)
    torch.cuda.synchronize()
    assert not errors and len(results) == n_icp
    assert all(torch.equal(T, want_T.cpu()) for T in results)
    for i, g in enumerate(got_r):
        assert all(torch.equal(g[k], want_r[i % 2][k]) for k in g), i
    assert flash_nn.launches - before == 30 * n_icp + 2 * n_reg
    assert register.graphed.captures == 1


def _fragment(seed, n, sx, sy):
    rng = np.random.RandomState(seed)
    uv = rng.rand(n, 2) * np.array([sx, sy])
    z = 0.2 * np.sin(uv[:, 0] * 3) * np.cos(uv[:, 1] * 2)
    return np.c_[uv, z].astype(np.float32)


# name → raw points: the grid path, the exact path (wider than the extent),
# and a cube of spread points whose coarse levels overflow the 1024 bucket
FRAGMENTS = {"grid": _fragment(1, 3000, 1.2, 1.2), "exact": _fragment(2, 1200, 2.0, 0.5),
             "escalation": (np.random.RandomState(3).rand(600, 3) * 1.0).astype(np.float32)}
EXTRACT_CFG = dict(conv1_kernel_size=3, model_n_out=16, compute_dtype="float32",
                   grid_extent=(64, 64, 64), grid_extent_buckets=None,
                   level_capacity_divisors=(1, 2, 4, 8), image_H=24, image_W=32)


@pytest.mark.cuda
def test_replayed_extractors_equal_the_eager_ones_bit_for_bit(card):
    cfg = threedmatch_config(**EXTRACT_CFG)
    model = _model(cfg).to(card).eval()
    buckets = (512, 1024, 2048)
    graphed = tx.make_bucketed_extractor(model, config=cfg, buckets=buckets)
    eager = tx.make_bucketed_extractor(model, config=cfg, buckets=buckets, graphed=False)
    image = np.random.RandomState(5).rand(1, 24, 32, 3).astype(np.float32)
    for name, pts in FRAGMENTS.items():
        raw, n = tx.pad_points_bucketed(pts, (4096,))
        (xe, fe), eager_launches = _delta(lambda: eager(raw, n, image))
        for _ in range(CALLS):
            (xg, fg), launches = _delta(lambda: graphed(raw, n, image))
            assert np.array_equal(xg, xe) and np.array_equal(fg, fe), name
            assert graphed.last == eager.last
        assert launches == eager_launches and launches[0] > 0, name
    assert len(graphed.last.tried) == 2           # the escalation, on replays too
    assert graphed.graphed["quantize"].captures == 2          # grid and exact paths
    # the one-program extractor: clones that outlive the next call
    one = tx.make_extractor(model, config=cfg, n_pad=2048)
    one_eager = tx.make_extractor(model, config=cfg, n_pad=2048, graphed=False)
    raw, n = tx.pad_points_bucketed(FRAGMENTS["grid"], (4096,))
    want = one_eager(raw, n, image)
    outs = [one(raw, n, image) for _ in range(CALLS)]
    for got in outs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert one.graphed.replays == CALLS - 1 and bool(one.fits)


@pytest.mark.cuda
@pytest.mark.parametrize("model_n_out", [16, 32])
def test_replayed_eval_kitti_pair_equals_the_eager_one(card, model_n_out):
    """Both forwards and the registration of one pair in one graph, the
    draws of pair i outside from the generator seeded with i."""
    cfg = threedmatch_config(**SMALL).replace(batch_size=1, model_n_out=model_n_out,
                                              ransac_max_iteration=4096)
    model = _model(cfg).to(card).eval()
    b = batch_to_device(collate_pairs([_val_pair()], N_PAD), card)
    graphed, eager = make_eval_pair(model, cfg), make_eval_pair(model, cfg, graphed=False)
    for i in range(CALLS):
        want, eager_launches = _delta(lambda: eager(i, b))
        got, launches = _delta(lambda: graphed(i, b))
        assert all(torch.equal(got[k], want[k]) for k in want), i
    assert graphed.graphed.captures == 1 and graphed.graphed.replays == CALLS - 1
    assert launches == eager_launches and launches[4] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("width", [16, 32, 64])
def test_replayed_scene_register_equals_the_eager_one(card, width):
    """eval-3dmatch's register, one graph per (keypoint pad, width, swap),
    RANSAC's uniforms drawn outside from the pair's generator."""
    cfg = threedmatch_config(ransac_max_iteration=8192)
    rng = np.random.RandomState(width)
    xyz0, _, _, xyz1, _, _, T = _reg_case()
    f0 = rng.randn(800, width).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 = (f0 + 0.05 * rng.randn(800, width)).astype(np.float32)
    case = [torch.from_numpy(a).to(card) for a in (xyz0, f0, np.arange(800) < 700,
                                                    xyz1, f1, np.arange(800) < 650)]
    T_gt, cov = torch.from_numpy(T).to(card), torch.eye(6, device=card)
    graphed = make_scene_register(cfg, 0.1, card)
    eager = make_scene_register(cfg, 0.1, card, graphed=False)
    for swap in (False, True):
        for k in range(CALLS):
            want, eager_launches = _delta(lambda: eager(k, *case, T_gt, cov, swap=swap))
            got, launches = _delta(lambda: graphed(k, *case, T_gt, cov, swap=swap))
            assert all(torch.equal(got[n], want[n]) for n in want), (swap, k)
            assert launches == eager_launches and launches[4] == 2
    assert graphed.graphed.captures == 2


@pytest.mark.cuda
def test_the_validation_step_at_16_d_replays_on_the_card(card):
    """model_n_out 16: the graphed validation step against the eager one."""
    cfg = threedmatch_config(**SMALL).replace(batch_size=1, val_subsample_size=512)
    assert cfg.model_n_out == 16
    b = batch_to_device(collate_pairs([_val_pair()], N_PAD), card)
    model = _model(cfg).to(card).eval()
    eager, graphed = make_val_step(model, cfg), make_graphed_val_step(model, cfg)
    for i in range(CALLS):
        want = eager(b, torch.Generator(device=card).manual_seed(i))
        got = graphed(b, torch.Generator(device=card).manual_seed(i))
        assert all(torch.equal(want[k], got[k]) for k in want), i


@pytest.mark.cuda
def test_cli_train_with_model_n_out_16_validates_on_the_card(card, tmp_path):
    """The documented flag that raised on the card before kernel B took
    every width: a training epoch and its validation."""
    out = tmp_path / "run"
    cli.main(["train", "--dataset", "synthetic", "--batch-size", "1", "--max-epoch", "1",
              "--lr", "0.05", "--voxel-size", "0.05", "--max-points", "1024",
              "--model-n-out", "16", "--conv1-kernel-size", "3", "--synthetic-length", "4",
              "--synthetic-n-points", "400", "--out-dir", str(out)])
    lines = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    val = [ln for ln in lines if ln["tag"].startswith("val")]
    assert val and all(np.isfinite(ln["value"]) for ln in val)
    assert any(name.startswith("best_val_checkpoint") for name in os.listdir(out))
