"""Port parity, registration: rigid fits, RANSAC with injected samples, and
the metric stack, against the JAX package; pose recovery with the port's
own random draws."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.match import metrics as jm
from imfnet_tpu.match import procrustes as jp
from imfnet_tpu.eval import registration as jreg
from imfnet_tpu.match.ransac import ransac_registration as jax_ransac

from imfnet_tpu_torch.match import metrics as tm
from imfnet_tpu_torch.match import procrustes as tp
from imfnet_tpu_torch.eval import registration as treg
from imfnet_tpu_torch.match.ransac import ransac_registration

FIT_ATOL = 1e-4   # f32 fits of O(1) coordinates, sums taken in another order


def _random_rigid(rng, max_angle=np.pi):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    ang = rng.rand() * max_angle
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.randn(3) * 0.5
    return T


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("power_iters", [0, 16])
def test_kabsch_soa_matches_jax(power_iters):
    rng = np.random.RandomState(0)
    src = rng.randn(64, 3, 3).astype(np.float32)     # 64 three-point fits
    dst = np.stack([s @ _random_rigid(rng)[:3, :3].T for s in src])
    dst = (dst + rng.randn(*dst.shape) * 0.01).astype(np.float32)
    Rj, tj = jp.kabsch_umeyama_soa(jnp.asarray(src), jnp.asarray(dst),
                                   power_iters=power_iters)
    Rt, tt = tp.kabsch_umeyama_soa(_t(src), _t(dst), power_iters=power_iters)
    np.testing.assert_allclose(tp.soa_to_matrix(Rt, tt).numpy(),
                               np.asarray(jp.soa_to_matrix(Rj, tj)),
                               rtol=0, atol=FIT_ATOL)


def test_kabsch_weighted_matches_jax():
    rng = np.random.RandomState(1)
    T = _random_rigid(rng)
    src = rng.randn(200, 3).astype(np.float32)
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    dst[:50] = rng.randn(50, 3)
    w = (np.arange(200) >= 50).astype(np.float32)
    Tj = np.asarray(jp.kabsch_umeyama(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(w)))
    Tt = tp.kabsch_umeyama(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(Tt, T, rtol=0, atol=1e-3)


def test_quaternion_round_trip_matches_jax():
    rng = np.random.RandomState(2)
    Rs = np.stack([_random_rigid(rng)[:3, :3] for _ in range(32)]).astype(np.float32)
    qj = np.asarray(jp.rotmat_to_quat(jnp.asarray(Rs)))
    qt = tp.rotmat_to_quat(_t(Rs)).numpy()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.quat_to_rotmat(_t(qt)).numpy(),
                               np.asarray(jp.quat_to_rotmat(jnp.asarray(qj))),
                               rtol=0, atol=1e-5)


def test_metrics_match_jax():
    rng = np.random.RandomState(3)
    T_gt = _random_rigid(rng)
    T_est = (T_gt @ _random_rigid(rng, max_angle=0.1)).astype(np.float32)
    T_est[:3, 3] += 0.05
    cov = np.eye(6, dtype=np.float32) + 0.1
    xyz = rng.rand(300, 3).astype(np.float32)
    xyz2 = (xyz @ T_gt[:3, :3].T + T_gt[:3, 3]
            + rng.randn(300, 3) * 0.05).astype(np.float32)
    valid = rng.rand(300) > 0.2
    J = {
        "te": jm.transform_error(jnp.asarray(T_gt), jnp.asarray(cov), jnp.asarray(T_est)),
        "re": jm.registration_error(jnp.asarray(T_gt), jnp.asarray(T_est)),
        "ir": jm.inlier_ratio(jnp.asarray(xyz2), jnp.asarray(xyz), jnp.asarray(T_gt),
                              valid=jnp.asarray(valid)),
        "cd": jm.corr_dist(jnp.asarray(T_est), jnp.asarray(T_gt), jnp.asarray(xyz),
                           jnp.asarray(valid)),
        "hr": jm.hit_ratio(jnp.asarray(xyz), jnp.asarray(xyz2), jnp.asarray(T_gt)),
        "pd": jm.pdist_sq(jnp.asarray(xyz[:20]), jnp.asarray(xyz2[:30])),
    }
    P = {
        "te": tm.transform_error(_t(T_gt), _t(cov), _t(T_est)),
        "re": tm.registration_error(_t(T_gt), _t(T_est)),
        "ir": tm.inlier_ratio(_t(xyz2), _t(xyz), _t(T_gt), valid=_t(valid)),
        "cd": tm.corr_dist(_t(T_est), _t(T_gt), _t(xyz), _t(valid)),
        "hr": tm.hit_ratio(_t(xyz), _t(xyz2), _t(T_gt)),
        "pd": tm.pdist_sq(_t(xyz[:20]), _t(xyz2[:30])),
    }
    for k in J:
        a = P[k] if isinstance(P[k], tuple) else (P[k],)
        b = J[k] if isinstance(J[k], tuple) else (J[k],)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def _ransac_case(seed, n=400, n_out=200):
    rng = np.random.RandomState(seed)
    T = _random_rigid(rng)
    src = (rng.rand(n, 3) * 3).astype(np.float32)
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    dst[:n_out] = rng.rand(n_out, 3) * 3
    dst += rng.randn(n, 3).astype(np.float32) * 0.003
    valid = rng.rand(n) > 0.05
    return T, src, dst, valid


def jax_samples(key, n_valid, num_hypotheses, hypo_block, ransac_n):
    """The draws ransac.py:97,160 makes: one key per block, randint in
    [0, max(n_valid, 1))."""
    n_blocks = -(-num_hypotheses // hypo_block)
    keys = jax.random.split(key, n_blocks)
    return np.stack([np.asarray(jax.random.randint(
        k, (hypo_block, ransac_n), 0, max(n_valid, 1))) for k in keys])


@pytest.mark.parametrize("refine", [True, False])
def test_ransac_matches_jax_with_injected_samples(refine):
    T, src, dst, valid = _ransac_case(4)
    key = jax.random.PRNGKey(7)
    kw = dict(ransac_n=3, num_hypotheses=600, hypo_block=200, refine=refine)
    res_j = jax_ransac(key, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
                       0.0375, **kw)
    samples = jax_samples(key, int(valid.sum()), 600, 200, 3)
    res_t = ransac_registration(_t(src), _t(dst), _t(valid), 0.0375,
                                samples=_t(samples), **kw)
    np.testing.assert_allclose(res_t.transformation.numpy(),
                               np.asarray(res_j.transformation), rtol=0, atol=FIT_ATOL)
    np.testing.assert_array_equal(res_t.inlier_mask.numpy(),
                                  np.asarray(res_j.inlier_mask))
    assert float(res_t.fitness) == pytest.approx(float(res_j.fitness), abs=1e-6)
    assert float(res_t.inlier_rmse) == pytest.approx(float(res_j.inlier_rmse), abs=1e-5)


def test_ransac_recovers_pose_with_outliers():
    """60% outliers, the port's own draws (tests/test_match.py pattern)."""
    rng = np.random.RandomState(0)
    T = _random_rigid(rng)
    n = 500
    src = (rng.rand(n, 3) * 4).astype(np.float32)
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    dst[:300] = rng.rand(300, 3) * 4
    g = torch.Generator().manual_seed(0)
    res = ransac_registration(_t(src), _t(dst), torch.ones(n, dtype=torch.bool),
                              0.0375, ransac_n=3, num_hypotheses=4096,
                              hypo_block=512, generator=g)
    rre, rte = tm.registration_error(_t(T), res.transformation)
    assert float(rre) < 1.0 and float(rte) < 0.05, (float(rre), float(rte))
    assert float(res.fitness) > 0.3


def test_ransac_rejects_bad_sample_shape():
    T, src, dst, valid = _ransac_case(5)
    with pytest.raises(ValueError, match="samples"):
        ransac_registration(_t(src), _t(dst), _t(valid), 0.0375,
                            num_hypotheses=100, hypo_block=50,
                            samples=torch.zeros((1, 50, 3), dtype=torch.long))


def test_keypoint_sampling_matches_jax_with_injected_keys():
    """The same uniform keys pick the same rows, without replacement."""
    key = jax.random.PRNGKey(11)
    n, k = 600, 150
    u = _t(np.asarray(jax.random.uniform(key, (n,))))
    valid = np.random.RandomState(1).rand(n) > 0.3
    rj, okj = jreg.sample_keypoints(key, jnp.asarray(valid), k)
    rt, okt = treg.sample_keypoints(_t(valid), k, u=u)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert valid[rt.numpy()].all() and len(set(rt.tolist())) == k
    rj, okj = jreg.sample_keypoints_segment(key, 100, 250, k, n)
    rt, okt = treg.sample_keypoints_segment(100, 250, k, n, u=u)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert ((rt >= 100) & (rt < 350)).all()
    g = torch.Generator().manual_seed(0)
    rg, okg = treg.sample_keypoints(_t(valid), k, generator=g)
    assert okg.all() and valid[rg.numpy()].all() and len(set(rg.tolist())) == k
