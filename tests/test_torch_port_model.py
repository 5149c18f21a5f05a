"""Port parity, model: flax weights carried over, and the image trunk, the
attention fusion, a residual block and the whole ResUNetIMF forward against
the JAX package's flax modules (``train=False``)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imfnet_tpu.models import load_model as jax_load_model
from imfnet_tpu.models.fusion import AttentionFusion as JaxFusion
from imfnet_tpu.models.layers import SparseBasicBlock as JaxBlock
from imfnet_tpu.models.resnet import ResNetTrunk as JaxTrunk
from imfnet_tpu.sparse.build import from_numpy
from imfnet_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid

from imfnet_tpu_torch.models import load_model
from imfnet_tpu_torch.models.fusion import LAYERNORM_EPS, AttentionFusion
from imfnet_tpu_torch.models.layers import SparseBasicBlock
from imfnet_tpu_torch.sparse.coords import SparseVoxels, row_mask
from imfnet_tpu_torch.sparse.kernel_map import build_pyramid
from imfnet_tpu_torch.utils.flax_weights import state_dict_from_flax

CAPS = (512, 256, 128, 64)
F32_ATOL = 1e-4   # f32 end to end; only the order of the f32 sums differs


def _cloud(rng, n, batch, span=12):
    pts = np.unique(rng.randint(-span, span, (4 * n, 3)), axis=0)[:n]
    return np.concatenate([np.full((len(pts), 1), batch), pts], 1).astype(np.int32)


def _randomize(tree, rng):
    """Non-trivial norm statistics and affine terms, so the norms matter."""
    def walk(t, path=()):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "mean":
                v = rng.randn(*v.shape).astype(np.float32) * 0.1
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k == "bias":
                v = rng.randn(*v.shape).astype(np.float32) * 0.1
            out[k] = v
        return out
    return walk(tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(1)
    coords = np.concatenate([_cloud(rng, 120, 0), _cloud(rng, 90, 1)])
    feats = rng.rand(len(coords), 1).astype(np.float32) + 0.5
    sv_j = from_numpy(coords, feats, CAPS[0])
    # jit: eager JAX runs op by op, several times slower here
    pyr_j = jax.jit(lambda c, n: jax_build_pyramid(
        c, n, conv1_kernel_size=5, level_capacity=CAPS))(sv_j.coords, sv_j.num_valid)
    images = rng.rand(2, 24, 32, 3).astype(np.float32)
    model = jax_load_model("ResUNetBN2C")(
        in_channels=1, out_channels=32, conv1_kernel_size=5,
        compute_dtype=jnp.float32)
    variables = jax.jit(lambda s, p, i: model.init(
        jax.random.PRNGKey(0), s, p, i, train=False))(sv_j, pyr_j,
                                                      jnp.asarray(images))
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)), rng)
    sv_t = SparseVoxels(torch.tensor(np.asarray(sv_j.coords)),
                        torch.tensor(np.asarray(sv_j.feats)),
                        torch.tensor(int(sv_j.num_valid), dtype=torch.int32))
    pyr_t = build_pyramid(sv_t.coords, sv_t.num_valid, conv1_kernel_size=5,
                          level_capacity=CAPS)
    return dict(sv_j=sv_j, pyr_j=pyr_j, sv_t=sv_t, pyr_t=pyr_t, images=images,
                variables=variables, rng=rng)


def _port_model(variables, dtype=torch.float32, occupancy=False):
    m = load_model("ResUNetBN2C")(in_channels=1, out_channels=32,
                                  conv1_kernel_size=5, compute_dtype=dtype,
                                  conv1_occupancy=occupancy)
    m.load_state_dict(state_dict_from_flax(variables), strict=True)
    return m.eval()


def test_state_dict_from_flax_round_trip(setup):
    variables = setup["variables"]
    p, bs = variables["params"], variables["batch_stats"]
    sd = state_dict_from_flax(variables)
    model = _port_model(variables)           # strict: every key, every shape
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    # sparse kernels stay [K, Cin, Cout]
    np.testing.assert_array_equal(sd["conv2.weight"].numpy(), p["conv2"]["kernel"])
    np.testing.assert_array_equal(sd["block1.conv1.weight"].numpy(),
                                  p["block1"]["SparseConv_1"]["kernel"])
    np.testing.assert_array_equal(sd["final.weight"].numpy(), p["final"]["kernel"])
    # flax Dense [in,out] → Linear [out,in]
    fa = p["attention_fusion"]
    np.testing.assert_array_equal(
        sd["attention_fusion.cross_attn.to_q.weight"].numpy(),
        fa["cross_attn"]["to_q"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["attention_fusion.cross_ff.wi.bias"].numpy(), fa["cross_ff"]["wi"]["bias"])
    # flax Conv HWIO → OIHW
    np.testing.assert_array_equal(
        sd["img_encoder.conv1.weight"].numpy(),
        p["img_encoder"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    # norms: scale → weight, batch_stats → running stats
    np.testing.assert_array_equal(
        sd["img_encoder.layer2_block0.down_bn.running_var"].numpy(),
        bs["img_encoder"]["layer2_block0"]["down_bn"]["var"])
    np.testing.assert_array_equal(
        sd["norm3.bn.weight"].numpy(), p["norm3"]["MaskedBatchNorm_0"]["scale"])
    np.testing.assert_array_equal(
        sd["block4.norm0.bn.running_mean"].numpy(),
        bs["block4"]["SparseNorm_0"]["MaskedBatchNorm_0"]["mean"])
    # eps: flax LayerNorm 1e-6 (not torch's 1e-5); batch norms 1e-5
    assert model.attention_fusion.cross_norm_q.eps == LAYERNORM_EPS == 1e-6
    assert model.norm1.bn.eps == 1e-5 and model.img_encoder.bn1.eps == 1e-5


def test_resnet_trunk_matches_jax(setup):
    v = setup["variables"]
    tvars = {"params": v["params"]["img_encoder"],
             "batch_stats": v["batch_stats"]["img_encoder"]}
    ref = JaxTrunk(compute_dtype=jnp.float32).apply(
        tvars, jnp.asarray(setup["images"]), train=False)
    out = _port_model(v).img_encoder(torch.from_numpy(setup["images"]))
    assert out.shape == ref.shape == (2, 3, 4, 128)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=F32_ATOL * max(1.0, np.abs(ref).max()))


def test_attention_fusion_matches_jax(setup):
    rng = np.random.RandomState(5)
    ctx = rng.randn(2, 12, 128).astype(np.float32)
    q = rng.randn(2, 40, 256).astype(np.float32)
    fvars = {"params": setup["variables"]["params"]["attention_fusion"]}
    ref = JaxFusion(dim=128, latent_dim=256, depth=0, cross_heads=1,
                    latent_heads=8, cross_dim_head=128, latent_dim_head=128,
                    compute_dtype=jnp.float32).apply(fvars, jnp.asarray(ctx),
                                                     jnp.asarray(q))
    out = _port_model(setup["variables"]).attention_fusion(
        torch.from_numpy(ctx), torch.from_numpy(q))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=F32_ATOL * np.abs(ref).max())


def test_attention_fusion_self_layers_match_jax():
    """depth > 0 (self-attention layers, 8 heads) at small widths."""
    rng = np.random.RandomState(7)
    ctx = rng.randn(2, 9, 12).astype(np.float32)
    q = rng.randn(2, 11, 16).astype(np.float32)
    kw = dict(dim=12, latent_dim=16, depth=2, cross_heads=1, latent_heads=8,
              cross_dim_head=8, latent_dim_head=4)
    jmod = JaxFusion(**kw, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(1), jnp.asarray(ctx), jnp.asarray(q)))
    ref = jmod.apply(params, jnp.asarray(ctx), jnp.asarray(q))
    tmod = AttentionFusion(**kw, compute_dtype=torch.float32)
    sd = state_dict_from_flax({"params": {"attention_fusion": params["params"]}})
    tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    out = tmod(torch.from_numpy(ctx), torch.from_numpy(q))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=F32_ATOL * np.abs(ref).max())


@pytest.mark.parametrize("norm_type", ["BN", "IN"])
def test_sparse_basic_block_matches_jax(setup, norm_type):
    v = setup["variables"]
    lv = setup["pyr_t"].levels[1]
    n = lv.coords.shape[0]
    x = np.random.RandomState(6).randn(n, 64).astype(np.float32)
    mask = row_mask(n, lv.num_valid)
    bids = torch.where(mask, lv.coords[:, 0].long(), torch.full((n,), 2))
    if norm_type == "BN":
        jvars = {"params": v["params"]["block2"],
                 "batch_stats": v["batch_stats"]["block2"]}
        block = _port_model(v).block2
    else:   # instance norm has no parameters; the convs keep block2's
        jvars = {"params": {k: v["params"]["block2"][k]
                            for k in ("SparseConv_0", "SparseConv_1")}}
        block = SparseBasicBlock(64, "IN", compute_dtype=torch.float32)
        block.conv0.weight.data = torch.tensor(jvars["params"]["SparseConv_0"]["kernel"])
        block.conv1.weight.data = torch.tensor(jvars["params"]["SparseConv_1"]["kernel"])
    ref = JaxBlock(64, norm_type, compute_dtype=jnp.float32).apply(
        jvars, jnp.asarray(x), setup["pyr_j"].levels[1].k3_same,
        jnp.asarray(mask.numpy()), setup["pyr_j"].levels[1].num_valid,
        jnp.asarray(bids.numpy()), 2, train=False)
    out = block(torch.from_numpy(x), lv.k3_same, mask, bids, 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=F32_ATOL * np.abs(ref).max())


def _descriptors(setup, occupancy, jdt, tdt):
    model = jax_load_model("ResUNetBN2C")(
        in_channels=1, out_channels=32, conv1_kernel_size=5,
        compute_dtype=jdt, conv1_occupancy=occupancy)
    sv_j = setup["sv_j"]
    if occupancy:   # the occupancy path assumes occupancy-1 features
        sv_j = sv_j._replace(feats=(jnp.arange(CAPS[0]) < sv_j.num_valid)[:, None]
                             .astype(jnp.float32))
    ref = np.asarray(model.apply(setup["variables"], sv_j, setup["pyr_j"],
                                 jnp.asarray(setup["images"]), train=False))
    sv_t = SparseVoxels(setup["sv_t"].coords, torch.tensor(np.asarray(sv_j.feats)),
                        setup["sv_t"].num_valid)
    out = _port_model(setup["variables"], tdt, occupancy)(
        sv_t, setup["pyr_t"], torch.from_numpy(setup["images"])).detach().numpy()
    return out, ref


@pytest.mark.parametrize("occupancy", [True, False])
def test_resunet_descriptors_f32(setup, occupancy):
    out, ref = _descriptors(setup, occupancy, jnp.float32, torch.float32)
    n = int(setup["sv_j"].num_valid)
    assert out.shape == ref.shape == (CAPS[0], 32)
    assert (out[n:] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(out[:n], axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("occupancy", [True, False])
def test_resunet_descriptors_bf16(setup, occupancy):
    """bf16 operands: both sides round to bf16 at different places (the JAX
    CPU conv strategies round per-offset partials, flax rounds Dense and
    Conv outputs inside XLA's fused graph), 2^-9 relative per rounding over
    ~25 layers. Measured here: 1.1e-3 abs on unit descriptors; the
    tolerance is 1e-2 abs and a cosine above 0.999 for every row."""
    out, ref = _descriptors(setup, occupancy, jnp.bfloat16, torch.bfloat16)
    n = int(setup["sv_j"].num_valid)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)
    cos = (out[:n] * ref[:n]).sum(1)
    assert cos.min() > 0.999, cos.min()
