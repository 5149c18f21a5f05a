"""ResUNetBN2C with the ResNet-34 image trunk and the attention fusion
(IMFNet, `model/resunet.py:25-273`, `model/resnet.py:195-216`,
`model/attention_fusion.py`) as plain functions of a parameter dict: every
batch norm on its running statistics for inference, on the batch's for a
training step.

``param_specs`` names every parameter and buffer with its shape and the
kind of values it holds (``benchlib.weights`` draws them from the seed);
the names are the state-dict keys the program's model loads, so one dict
serves both. ``descriptors`` is the forward: L2-normalized descriptors of
every voxel of a table.

Departures from the published model, each one the program's too: the
first conv's input is the occupancy (all features are one), the fusion's
LayerNorm eps is 1e-6 (flax's default), and the GEGLU's gelu is the exact
erf form.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference.precision import Precision
from reference.voxels import Pyramid

Spec = Tuple[str, Tuple[int, ...], str, int]   # name, shape, kind, fan-in
LN_EPS = 1e-6
BN_EPS = 1e-5


def _bn(name: str, c: int, out: List[Spec], tracked: bool = False) -> None:
    out += [(f"{name}.weight", (c,), "scale", 0), (f"{name}.bias", (c,), "shift", 0),
            (f"{name}.running_mean", (c,), "shift", 0),
            (f"{name}.running_var", (c,), "variance", 0)]
    if tracked:
        out.append((f"{name}.num_batches_tracked", (), "count", 0))


def param_specs(m: Dict) -> List[Spec]:
    """Every parameter and buffer of the model the configuration ``m``
    (the config file's ``model`` group) describes."""
    ch, tr = m["channels"], m["tr_channels"]
    k1 = m["conv1_kernel_size"] ** 3
    out: List[Spec] = []

    def conv(name, k, cin, cout):
        out.append((f"{name}.weight", (k, cin, cout), "weight", k * cin))

    def block(name, c):
        for j in range(2):
            conv(f"{name}.conv{j}", 27, c, c)
            _bn(f"{name}.norm{j}.bn", c, out)

    conv("conv1", k1, m["in_channels"], ch[0])
    _bn("norm1.bn", ch[0], out)
    block("block1", ch[0])
    for i in range(1, 4):
        conv(f"conv{i + 1}", 27, ch[i - 1], ch[i])
        _bn(f"norm{i + 1}.bn", ch[i], out)
        block(f"block{i + 1}", ch[i])
    _resnet_specs(m, out)
    _fusion_specs(m, out)
    conv("conv4_tr", 27, ch[3], tr[3])
    _bn("norm4_tr.bn", tr[3], out)
    block("block4_tr", tr[3])
    conv("conv3_tr", 27, ch[2] + tr[3], tr[2])
    _bn("norm3_tr.bn", tr[2], out)
    block("block3_tr", tr[2])
    conv("conv2_tr", 27, ch[1] + tr[2], tr[1])
    _bn("norm2_tr.bn", tr[1], out)
    block("block2_tr", tr[1])
    out.append(("conv1_tr.weight", (ch[0] + tr[1], tr[0]), "weight", ch[0] + tr[1]))
    out.append(("final.weight", (tr[0], m["out_channels"]), "weight", tr[0]))
    out.append(("final.bias", (m["out_channels"],), "shift", 0))
    return out


def _resnet_specs(m: Dict, out: List[Spec]) -> None:
    p = "img_encoder"
    out.append((f"{p}.conv1.weight", (64, 3, 7, 7), "weight", 3 * 49))
    _bn(f"{p}.bn1", 64, out, tracked=True)
    cin = 64
    for i, (n, w) in enumerate(zip(m["resnet_stage_sizes"], m["resnet_widths"])):
        for j in range(n):
            b = f"{p}.layer{i + 1}_block{j}"
            out.append((f"{b}.conv1.weight", (w, cin, 3, 3), "weight", cin * 9))
            _bn(f"{b}.bn1", w, out, tracked=True)
            out.append((f"{b}.conv2.weight", (w, w, 3, 3), "weight", w * 9))
            _bn(f"{b}.bn2", w, out, tracked=True)
            if j == 0 and (i > 0 or w != 64):
                out.append((f"{b}.down_conv.weight", (w, cin, 1, 1), "weight", cin))
                _bn(f"{b}.down_bn", w, out, tracked=True)
            cin = w


def _fusion_specs(m: Dict, out: List[Spec]) -> None:
    p = "attention_fusion"
    lat, dim = m["channels"][3], m["image_channels"]
    inner = lat // 2                      # one cross head of latent_dim // 2
    ff = 4 * lat
    out += [(f"{p}.cross_norm_q.weight", (lat,), "scale", 0),
            (f"{p}.cross_norm_q.bias", (lat,), "shift", 0),
            (f"{p}.cross_norm_ctx.weight", (dim,), "scale", 0),
            (f"{p}.cross_norm_ctx.bias", (dim,), "shift", 0),
            (f"{p}.cross_attn.to_q.weight", (inner, lat), "weight", lat),
            (f"{p}.cross_attn.to_kv.weight", (2 * inner, dim), "weight", dim),
            (f"{p}.cross_attn.to_out.weight", (lat, inner), "weight", inner),
            (f"{p}.cross_attn.to_out.bias", (lat,), "shift", 0),
            (f"{p}.cross_ff_norm.weight", (lat,), "scale", 0),
            (f"{p}.cross_ff_norm.bias", (lat,), "shift", 0),
            (f"{p}.cross_ff.wi.weight", (2 * ff, lat), "weight", lat),
            (f"{p}.cross_ff.wi.bias", (2 * ff,), "shift", 0),
            (f"{p}.cross_ff.wo.weight", (lat, ff), "weight", ff),
            (f"{p}.cross_ff.wo.bias", (lat,), "shift", 0)]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def sparse_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                prec: Precision) -> torch.Tensor:
    """out[n] = sum_k x[nbr[n, k]] @ w[k], a missing neighbour adding
    nothing."""
    xr, wr = prec.round(x), prec.round(w)
    out = torch.zeros((nbr.shape[0], w.shape[2]), device=x.device)
    for k in range(nbr.shape[1]):
        rows = torch.nonzero(nbr[:, k] >= 0).squeeze(1)
        if len(rows):
            out.index_add_(0, rows, xr[nbr[rows, k]] @ wr[k])
    return out


def _norm(P, name, x, train=False):
    """Batch norm over the voxels: on the running statistics, or in
    training on the batch's (mean and biased variance of every voxel)."""
    if train:
        mean, var = x.mean(0), x.var(0, unbiased=False)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]) + P[f"{name}.bias"]


def _block(P, name, x, nbr, prec, train=False):
    out = torch.relu(_norm(P, f"{name}.norm0.bn",
                           sparse_conv(x, nbr, P[f"{name}.conv0.weight"], prec), train))
    out = _norm(P, f"{name}.norm1.bn",
                sparse_conv(out, nbr, P[f"{name}.conv1.weight"], prec), train)
    return torch.relu(out + x)


def _bn2d(P, name, x, train=False):
    if train:
        return F.batch_norm(x, None, None, P[f"{name}.weight"], P[f"{name}.bias"],
                            training=True, eps=BN_EPS)
    return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"],
                        P[f"{name}.weight"], P[f"{name}.bias"], training=False, eps=BN_EPS)


def image_tokens(P, images: torch.Tensor, m: Dict, prec: Precision,
                 train: bool = False) -> torch.Tensor:
    """ResNet-34 through layer2 on NHWC images in [0, 1] → tokens
    [B, H/8 * W/8, 128]."""
    p = "img_encoder"
    x = images.permute(0, 3, 1, 2).float()
    x = torch.relu(_bn2d(P, f"{p}.bn1", prec.conv2d(x, P[f"{p}.conv1.weight"], 2, 3), train))
    x = F.max_pool2d(x, 3, 2, 1)
    cin = 64
    for i, (n, w) in enumerate(zip(m["resnet_stage_sizes"], m["resnet_widths"])):
        for j in range(n):
            b = f"{p}.layer{i + 1}_block{j}"
            stride = 2 if (i > 0 and j == 0) else 1
            out = torch.relu(_bn2d(P, f"{b}.bn1",
                                   prec.conv2d(x, P[f"{b}.conv1.weight"], stride, 1), train))
            out = _bn2d(P, f"{b}.bn2", prec.conv2d(out, P[f"{b}.conv2.weight"], 1, 1), train)
            idn = x
            if j == 0 and (i > 0 or w != 64):
                idn = _bn2d(P, f"{b}.down_bn", prec.conv2d(x, P[f"{b}.down_conv.weight"],
                                                           stride, 0), train)
            x = torch.relu(out + idn)
            cin = w
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def fuse(P, queries: torch.Tensor, tokens: torch.Tensor, prec: Precision) -> torch.Tensor:
    """One PreNorm cross-attention block with a GEGLU feed-forward, both
    residual (fusion depth 0): queries [M, 256] of one cloud, tokens
    [T, 128] of its image."""
    p = "attention_fusion"

    def ln(x, name):
        return F.layer_norm(x, (x.shape[-1],), P[f"{p}.{name}.weight"],
                            P[f"{p}.{name}.bias"], LN_EPS)

    q = prec.linear(ln(queries, "cross_norm_q"), P[f"{p}.cross_attn.to_q.weight"])
    kv = prec.linear(ln(tokens, "cross_norm_ctx"), P[f"{p}.cross_attn.to_kv.weight"])
    k, v = kv.chunk(2, dim=-1)
    att = torch.softmax(prec.mm(q, k.T) * q.shape[-1] ** -0.5, dim=-1)
    x = prec.linear(prec.mm(att, v), P[f"{p}.cross_attn.to_out.weight"],
                    P[f"{p}.cross_attn.to_out.bias"]) + queries
    h = prec.linear(ln(x, "cross_ff_norm"), P[f"{p}.cross_ff.wi.weight"],
                    P[f"{p}.cross_ff.wi.bias"])
    x1, gates = h.chunk(2, dim=-1)
    return prec.linear(x1 * F.gelu(gates), P[f"{p}.cross_ff.wo.weight"],
                       P[f"{p}.cross_ff.wo.bias"]) + x


def descriptors(P: Dict[str, torch.Tensor], pyr: Pyramid, images: torch.Tensor,
                m: Dict, prec: Precision, train: bool = False) -> torch.Tensor:
    """f32[N0, out_channels]: unit descriptors of the voxels of
    ``pyr.tables[0]``; ``images[b]`` is the image of the cloud whose batch
    index is b. ``train``: every norm on the batch's statistics."""
    same, down, up = pyr.same, pyr.down, pyr.up
    # conv1 on occupancy: every input feature is one
    occ = (pyr.conv1 >= 0).float()
    out = prec.mm(occ, P["conv1.weight"][:, 0, :])
    s1 = _block(P, "block1", _norm(P, "norm1.bn", out, train), same[0], prec, train)
    out = sparse_conv(s1, down[1], P["conv2.weight"], prec)
    s2 = _block(P, "block2", _norm(P, "norm2.bn", out, train), same[1], prec, train)
    out = sparse_conv(s2, down[2], P["conv3.weight"], prec)
    s4 = _block(P, "block3", _norm(P, "norm3.bn", out, train), same[2], prec, train)
    out = sparse_conv(s4, down[3], P["conv4.weight"], prec)
    out = _block(P, "block4", _norm(P, "norm4.bn", out, train), same[3], prec, train)

    tokens = image_tokens(P, images, m, prec, train)
    batch3 = pyr.tables[3][:, 0]
    fused = []
    for b in range(images.shape[0]):
        rows = torch.nonzero(batch3 == b).squeeze(1)
        fused.append(fuse(P, out[rows], tokens[b], prec))
    out = torch.cat(fused)        # rows are sorted by batch index

    out = sparse_conv(out, up[2], P["conv4_tr.weight"], prec)
    out = _block(P, "block4_tr", _norm(P, "norm4_tr.bn", out, train), same[2], prec, train)
    out = sparse_conv(torch.cat([out, s4], 1), up[1], P["conv3_tr.weight"], prec)
    out = _block(P, "block3_tr", _norm(P, "norm3_tr.bn", out, train), same[1], prec, train)
    out = sparse_conv(torch.cat([out, s2], 1), up[0], P["conv2_tr.weight"], prec)
    out = _block(P, "block2_tr", _norm(P, "norm2_tr.bn", out, train), same[0], prec, train)
    out = torch.relu(prec.mm(torch.cat([out, s1], 1), P["conv1_tr.weight"]))
    out = prec.mm(out, P["final.weight"]) + P["final.bias"]
    return out / out.norm(dim=1, keepdim=True).clamp_min(1e-12)


def conv_calls(pyr: Pyramid, m: Dict) -> Sequence[Tuple[str, torch.Tensor, int, int, int]]:
    """(name, map, n_in, cin, cout) of the forward's k > 1 sparse convs in
    the order the forward runs them (conv1 first; ``n_in`` the input
    table's rows)."""
    ch, tr = m["channels"], m["tr_channels"]
    n = [len(t) for t in pyr.tables]
    calls = [("conv1", pyr.conv1, n[0], m["in_channels"], ch[0])]

    def block(name, i, c):
        calls.extend((f"{name}.conv{j}", pyr.same[i], n[i], c, c) for j in range(2))

    block("block1", 0, ch[0])
    for i in range(1, 4):
        calls.append((f"conv{i + 1}", pyr.down[i], n[i - 1], ch[i - 1], ch[i]))
        block(f"block{i + 1}", i, ch[i])
    ins = (ch[3], ch[2] + tr[3], ch[1] + tr[2])
    for j, i in enumerate((2, 1, 0)):
        calls.append((f"conv{i + 2}_tr", pyr.up[i], n[i + 1], ins[j], tr[i + 1]))
        block(f"block{i + 2}_tr", i, tr[i + 1])
    return calls
