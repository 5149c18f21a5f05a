"""Port parity, losses: the four metric-learning losses of
``imfnet_tpu_torch.train.losses`` against ``imfnet_tpu.train.losses`` on the
same features, pairs and random draws (the JAX draws are injected), the
pair-set membership, and samplers with fewer valid rows than samples."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.train import losses as jl

from imfnet_tpu_torch.train import losses as tl

ATOL = 1e-5   # f32 on both sides; only the order of the f32 sums differs


def _inputs(seed, n0=300, n1=280, valid0=260, valid1=250, n_pairs=200, valid_pairs=170,
            dim=16):
    rng = np.random.RandomState(seed)
    f0 = rng.randn(n0, dim).astype(np.float32)
    f1 = rng.randn(n1, dim).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    v0 = np.arange(n0) < valid0
    v1 = np.arange(n1) < valid1
    pairs = np.stack([rng.randint(0, max(valid0, 1), n_pairs),
                      rng.randint(0, max(valid1, 1), n_pairs)], 1).astype(np.int32)
    pv = np.arange(n_pairs) < valid_pairs
    return f0, v0, f1, v1, pairs, pv


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def _t(args, grad=False):
    out = [torch.from_numpy(np.asarray(a)) for a in args]
    if grad:
        out[0].requires_grad_()
        out[2].requires_grad_()
    return tuple(out)


def _uniform(key, n):
    return torch.tensor(np.asarray(jax.random.uniform(key, (n,))))


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [dict(), dict(valid0=40, valid1=30, valid_pairs=20)],
                         ids=["enough rows", "fewer valid rows than samples"])
def test_hardest_contrastive_loss_matches_jax(shape):
    args = _inputs(0, **shape)
    key = jax.random.PRNGKey(3)
    kw = dict(num_pos=64, num_hn_samples=48, pos_thresh=0.1, neg_thresh=1.4)
    ref = jl.hardest_contrastive_loss(key, *_j(args), **kw)
    k0, k1, k2 = jax.random.split(key, 3)
    draws = (_uniform(k0, 300), _uniform(k1, 280), _uniform(k2, 200))
    targs = _t(args, grad=True)
    got = tl.hardest_contrastive_loss(*targs, **kw, draws=draws)
    _close(got, ref)
    # and its gradient in the features
    gref = jax.grad(lambda a, b: sum(jl.hardest_contrastive_loss(
        key, a, jnp.asarray(args[1]), b, *_j(args[3:]), **kw)), argnums=(0, 1))(
            jnp.asarray(args[0]), jnp.asarray(args[2]))
    (got[0] + got[1]).backward()
    _close((targs[0].grad, targs[2].grad), gref)


def test_contrastive_loss_matches_jax():
    args = _inputs(1)
    key = jax.random.PRNGKey(4)
    ref = jl.contrastive_loss(key, *_j(args), neg_thresh=1.4)
    k0, k1 = jax.random.split(key)
    num_neg = 2 * len(args[4])
    draws = (torch.tensor(np.asarray(jax.random.randint(k0, (num_neg,), 0, 260))),
             torch.tensor(np.asarray(jax.random.randint(k1, (num_neg,), 0, 250))))
    _close(tl.contrastive_loss(*_t(args), neg_thresh=1.4, draws=draws), ref)


@pytest.mark.parametrize("shape", [dict(), dict(valid1=30, valid_pairs=20)],
                         ids=["enough rows", "fewer valid rows than samples"])
def test_triplet_loss_matches_jax(shape):
    args = _inputs(2, **shape)
    key = jax.random.PRNGKey(5)
    kw = dict(num_pos=64, num_rand_triplet=96, neg_thresh=1.4)
    ref = jl.triplet_loss(key, *_j(args), **kw)
    k0, k1, k2 = jax.random.split(key, 3)
    draws = (_uniform(k0, 200), _uniform(k1, 200), _uniform(k2, 280))
    _close(tl.triplet_loss(*_t(args), **kw, draws=draws), ref)


@pytest.mark.parametrize("shape", [dict(), dict(valid0=40, valid1=60, valid_pairs=20)],
                         ids=["enough rows", "fewer valid rows than samples"])
def test_hardest_triplet_loss_matches_jax(shape):
    args = _inputs(3, **shape)
    key = jax.random.PRNGKey(6)
    kw = dict(num_pos=64, num_hn_samples=48, num_rand_triplet=96, neg_thresh=1.4)
    ref = jl.hardest_triplet_loss(key, *_j(args), **kw)
    ks = jax.random.split(key, 5)
    draws = tuple(_uniform(k, n) for k, n in zip(ks, (300, 280, 200, 200, 280)))
    _close(tl.hardest_triplet_loss(*_t(args), **kw, draws=draws), ref)


def test_pair_set_membership_matches_jax():
    rng = np.random.RandomState(7)
    pairs = rng.randint(0, 1000, (50, 2)).astype(np.int32)
    valid = rng.rand(50) < 0.8
    qi = np.concatenate([pairs[:, 0], pairs[:, 0] + 2000, pairs[:, 1]])
    qj = np.concatenate([pairs[:, 1], pairs[:, 1], pairs[:, 0]])
    ref = jl._in_pair_set(jl._make_pair_set(jnp.asarray(pairs), jnp.asarray(valid)),
                          jnp.asarray(qi), jnp.asarray(qj))
    table = tl._make_pair_set(torch.from_numpy(pairs), torch.from_numpy(valid))
    got = tl._in_pair_set(table, torch.from_numpy(qi), torch.from_numpy(qj))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[:50].numpy().tolist() == valid.tolist()     # invalid pairs are no members


def test_pair_keys_hold_rows_beyond_16_bits():
    """The int64 key keeps rows >= 2^16 apart, which a 16-bit field folds."""
    pairs = torch.tensor([[70000, 3], [5, 70001]], dtype=torch.int32)
    table = tl._make_pair_set(pairs, torch.ones(2, dtype=torch.bool))
    got = tl._in_pair_set(table, torch.tensor([70000, 70000 - 65536, 5]),
                          torch.tensor([3, 3, 70001]))
    assert got.tolist() == [True, False, True]


def test_sampler_draws_from_a_generator_and_masks_the_tail():
    valid = torch.arange(100) < 7
    idx, ok = tl._sample_without_replacement(valid, 10, torch.Generator().manual_seed(0))
    assert ok.tolist() == [True] * 7 + [False] * 3
    assert sorted(idx[:7].tolist()) == list(range(7))
    # a loss with no injected draws runs from the generator alone
    args = _t(_inputs(8))
    pos, neg = tl.hardest_contrastive_loss(*args, num_pos=32, num_hn_samples=16,
                                           generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(pos) and torch.isfinite(neg)
