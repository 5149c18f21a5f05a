"""The compiled programs on the card (``cuda`` marker; each test skips
without one): the training step, the validation step, ``register`` and
``PairRegistrar`` replayed as CUDA graphs (``utils.graphs.jit``) against
their eager calls bit for bit, the kernel launches a replay counts against
an eager call's, and a resumed graphed trainer against the uninterrupted
one and against the eager trainer. The file imports no JAX, so that it runs
where flax is missing; ``tests/test_torch_port_graphs.py`` holds the CPU
side and imports the helpers below.

    python3 -m pytest tests/test_torch_port_graphs_card.py -q -p no:cacheprovider
"""
import glob
import os

import numpy as np
import pytest
import torch

from imfnet_tpu_torch.config import threedmatch_config
from imfnet_tpu_torch.data.collate import collate_pairs
from imfnet_tpu_torch.data.datasets import make_data_loader
from imfnet_tpu_torch.data.synthetic import synthetic_batch, synthetic_pair
from imfnet_tpu_torch.eval.registration import make_pair_registration
from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.pipeline import PairRegistrar, bench_config
from imfnet_tpu_torch.train.state import create_train_state
from imfnet_tpu_torch.train.step import make_graphed_train_step, make_train_step
from imfnet_tpu_torch.train.trainer import Trainer, batch_to_device
from imfnet_tpu_torch.train.validate import make_graphed_val_step, make_val_step
from imfnet_tpu_torch.utils import graphs

SMALL = dict(batch_size=2, conv1_kernel_size=3, model_n_out=16, num_pos_per_batch=128,
             num_hn_samples_per_batch=64, max_points=2048, compute_dtype="float32")
N_PAD = SMALL["max_points"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured and replayed only on a card")
    return torch.device("cuda")


def _batch(device="cpu", seed=0):
    return synthetic_batch(np.random.RandomState(seed), batch_size=2, n_points=700,
                           n_pad=N_PAD, image_hw=(24, 32), device=device)


def _model(cfg, seed=3):
    torch.manual_seed(seed)
    return load_model(cfg.model)(in_channels=1, out_channels=cfg.model_n_out,
                                 conv1_kernel_size=cfg.conv1_kernel_size,
                                 compute_dtype=torch.float32)


def _state_tensors(state):
    """Parameters, buffers and the optimizer's per-parameter state."""
    out = dict(state.model.state_dict())
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt{i}.{k}": v for k, v in st.items()})
    return out


def _assert_states_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys() and a.step == b.step
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert float(a.optimizer.param_groups[0]["lr"]) == float(b.optimizer.param_groups[0]["lr"])


def _run_both(cfg, batch, n_steps, device, plain_state, graphed_state):
    """n_steps of make_train_step and of make_graphed_train_step from
    generators of one seed; returns both metrics lists and generators."""
    plain, graphed = make_train_step(cfg), make_graphed_train_step(cfg)
    gp = torch.Generator(device=device).manual_seed(5)
    gg = torch.Generator(device=device).manual_seed(5)
    mp, mg = [], []
    for _ in range(n_steps):
        mp.append({k: v.clone() for k, v in plain(plain_state, batch, gp)[1].items()})
        mg.append({k: v.clone() for k, v in graphed(graphed_state, batch, gg)[1].items()})
    return mp, mg, gp, gg, graphed


def _val_pair():
    """tests/test_torch_port_train_parts.py's pair: both sides hold the
    same voxels and image, side 1's points side 0's under a known pose."""
    p = synthetic_pair(np.random.RandomState(7), n_points=900, extent=0.45, image_hw=(24, 32))
    ang = 0.25
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    T[:3, 3] = [0.2, -0.1, 0.05]
    p.coords1, p.feats1, p.image1, p.T_gt = p.coords0, p.feats0, p.image0, T
    p.xyz1 = (p.xyz0 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return p


REG = dict(num_keypoints=300, voxel_size=0.025, ransac_n=3, num_hypotheses=1000,
           inlier_thresh=0.1, hypo_block=500)


def _reg_case():
    """Two 800-row sides of one cloud under a known pose, descriptors that
    identify the rows with noise (32-d: kernel B serves D 3 and 32), 700 and
    650 valid rows."""
    rng = np.random.RandomState(4)
    n = 800
    xyz0 = (rng.rand(n, 3) * 2).astype(np.float32)
    ang = 0.3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    T[:3, 3] = [0.3, 0.1, -0.2]
    perm = rng.permutation(n)
    xyz1 = (xyz0[perm] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    f0 = rng.randn(n, 32).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 = f0[perm] + 0.05 * rng.randn(n, 32).astype(np.float32)
    # gt maps side 1 onto side 0, as gt.log does
    return xyz0, f0, 700, xyz1, f1, 650, np.linalg.inv(T).astype(np.float32)


def _registrar_config():
    return bench_config().replace(compute_dtype="float32", num_rand_keypoints=400,
                                  ransac_max_iteration=12500,
                                  level_capacity_divisors=(1, 2, 4, 8))


def _launches():
    return graphs._read_counters()


@pytest.mark.cuda
def test_replayed_train_step_equals_the_eager_one_bit_for_bit(card):
    """Four steps (warm-up, capture, two replays) crossing an epoch
    boundary: parameters, buffers, momentum, rate, metrics, generator; and
    a replay counts the kernel launches an eager step makes."""
    cfg = threedmatch_config(**SMALL, exp_gamma=0.5)
    batch = _batch(card)
    states = [create_train_state(_model(cfg).to(card), cfg, steps_per_epoch=2)
              for _ in range(2)]
    mp, mg, gp, gg, step = _run_both(cfg, batch, 4, card, *states)
    _assert_states_equal(*states)
    for a, b in zip(mp, mg):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(gp.get_state(), gg.get_state())
    assert step.graphed.captures == 1 and step.graphed.replays == 3
    before = _launches()
    make_train_step(cfg)(states[0], batch, gp)
    eager = [a - b for a, b in zip(_launches(), before)]
    before = _launches()
    step(states[1], batch, gg)
    torch.cuda.synchronize()
    replay = [a - b for a, b in zip(_launches(), before)]
    assert replay == eager and replay[0] > 0 and replay[4] == 2


@pytest.mark.cuda
def test_replayed_val_step_and_register_equal_the_eager_ones(card):
    # 32-d descriptors: kernel B serves D 3 and 32
    cfg = threedmatch_config(**SMALL).replace(batch_size=1, val_subsample_size=512,
                                              model_n_out=32)
    b = batch_to_device(collate_pairs([_val_pair()], N_PAD), card)
    model = _model(cfg).to(card).eval()
    eager, graphed = make_val_step(model, cfg), make_graphed_val_step(model, cfg)
    for i in range(3):
        want = eager(b, torch.Generator(device=card).manual_seed(i))
        got = graphed(b, torch.Generator(device=card).manual_seed(i))
        assert all(torch.equal(want[k], got[k]) for k in want), i
    assert graphed.graphed.replays == 2
    case = [torch.as_tensor(a).to(card) for a in _reg_case()]
    cov = torch.eye(6, device=card)
    register = make_pair_registration(**REG)
    for i in range(3):
        gr = torch.Generator(device=card).manual_seed(i)
        gs = torch.Generator(device=card).manual_seed(i)
        got = register(*case, cov, generator=gr)
        u = tuple(torch.rand(800, generator=gs, device=card) for _ in range(2))
        s = torch.rand((2, REG["hypo_block"], 3), generator=gs, device=card)
        want = register.graphed.fn(*case, cov, *u, s)
        assert all(torch.equal(want[k], got[k]) for k in want), i
    assert register.graphed.replays == 2


@pytest.mark.cuda
def test_replayed_pair_registrar_equals_the_eager_one(card):
    cfg = _registrar_config()
    pair = synthetic_pair(np.random.RandomState(2), n_points=6000, image_hw=(24, 32))
    graphed, eager = PairRegistrar(cfg, seed=1), PairRegistrar(cfg, seed=1, graphed=False)
    args = (pair.xyz0, pair.xyz1, pair.image0, pair.image1, pair.T_gt, np.eye(6))
    for i in range(3):
        got = graphed(*args, generator=torch.Generator(device=card).manual_seed(i))
        want = eager(*args, generator=torch.Generator(device=card).manual_seed(i))
        assert all(torch.equal(want[k], got[k]) for k in want), i
    assert graphed.graphed.captures == 1 and graphed.graphed.replays == 2
    counts = graphed.graphed.launches_per_replay()
    assert counts["gather_gemm.launches"] == 20 and counts["flash_nn.launches"] == 2


def _card_trainer(out_dir, graphed=True, **kw):
    cfg = threedmatch_config(
        dataset="SyntheticPairDataset", synthetic_length=4, synthetic_n_points=400,
        batch_size=1, max_points=1024, voxel_size=0.05, conv1_kernel_size=3,
        model_n_out=32, num_pos_per_batch=64, num_hn_samples_per_batch=32,
        compute_dtype="float32", data_parallel=1, out_dir=str(out_dir),
        use_random_rotation=True, stat_freq=1, val_max_iter=2, lr=0.05, **kw)
    return Trainer(cfg, make_data_loader(cfg, "train", 1, workers=0),
                   make_data_loader(cfg, "val", 1), device="cuda", graphed=graphed)


@pytest.mark.cuda
def test_a_resumed_graphed_trainer_equals_the_uninterrupted_one(card, tmp_path):
    whole = _card_trainer(tmp_path / "whole", max_epoch=2)
    whole.init_state()
    whole.train()
    part = _card_trainer(tmp_path / "part", max_epoch=1)
    part.init_state()
    part.train()
    (ckpt,) = glob.glob(os.path.join(part.out_dir, "checkpoint_epoch_1_*"))
    rest = _card_trainer(tmp_path / "part", max_epoch=2, resume=ckpt, test_valid=False)
    rest.init_state()
    rest.train()
    assert whole.graphed and whole.train_step.graphed.replays > 0
    _assert_states_equal(whole.state, rest.state)
    eager = _card_trainer(tmp_path / "eager", graphed=False, max_epoch=2)
    eager.init_state()
    eager.train()
    _assert_states_equal(whole.state, eager.state)
    assert torch.equal(whole.generator.get_state(), eager.generator.get_state())
