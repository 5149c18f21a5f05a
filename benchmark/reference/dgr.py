"""Deep Global Registration's inlier network and weighted Procrustes, plain
PyTorch (Choy, Dong and Koltun, CVPR 2020; github.com/chrischoy/
DeepGlobalRegistration: ``config.py``'s inlier options, ``model/resunet.py``
``ResUNetBN2C`` at D = 6, ``core/registration.py``'s weighted Procrustes).

Everything is worked out here again from the scans' points, the
correspondences (each source voxel's match in the target scan) and the
weights the benchmark made; nothing of the program under test is imported.

- **Voxels**: one 6-D point a correspondence, ``(floor(p / v), floor(q /
  v))`` by a true float32 division, with a batch column of 0; the table is
  the points sorted lexicographically by a stable sort on each column, last
  column first. A level of the pyramid holds the unique ``floor(u / 2^i) *
  2^i`` of level 0, every axis strided.
- **Maps**: ``nbr[N_out, 3^6]`` gives, for each output point and offset
  (the first axis slowest, in product order, scaled by the level's
  stride), the input row or -1: each point gets an integer id in mixed
  radix over the table's own span, padded by the largest offset, and each
  offset's ids are searched in the sorted ids of the input table.
- **Network**: ``ResUNetBN2C`` at D = 6, one input channel (every feature
  is one), 32-64-128-256 channels, decoder 64-64-64-128, conv1 k3, one
  output logit, every batch norm on its running statistics, no feature
  normalization. A sparse conv is ``Σ_k x[nbr[:, k]] @ W[k]``, its live
  entries grouped by offset, one product an offset; the products run in a
  ``precision.Precision``, f32 the reference, called inside
  ``precision.full_f32()`` (TF32 off in matmuls and cuDNN).
- **Weights**: ``sigmoid(logit)``, set to 0 below ``clip_weight_thresh``.
- **Pose**: ``argmin_{R,t} Σ_j w_j ‖R p_j + t − q_j‖²`` by an SVD of the
  weighted covariance in float64, a reflection corrected; the control
  rounds its operands to bfloat16 first.

Departures from DGR, each the program's too: DGR's safeguard (RANSAC where
Σw falls below ``wsum_threshold``) and its pose refinement are left out,
since with weights from the seed the branch tells nothing; the weights are
drawn from the seed (``benchlib.weights``), no released checkpoint being in
the repository.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from reference.model import BN_EPS, _bn
from reference.precision import Precision

DIM = 6
NUM_LEVELS = 4


# ---- voxels and maps -------------------------------------------------------

def cells(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    v = torch.full((), voxel_size, dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz.float() / v).to(torch.int64)


def lex_sort(c: torch.Tensor) -> torch.Tensor:
    """The rows' order, lexicographic over the columns: stable sorts on
    each column, last column first."""
    order = torch.arange(len(c), device=c.device)
    for a in reversed(range(c.shape[1])):
        order = order[torch.sort(c[order, a], stable=True).indices]
    return order


def unique_rows(c: torch.Tensor) -> torch.Tensor:
    """The distinct rows of ``c``, sorted lexicographically."""
    s = c[lex_sort(c)]
    if len(s) == 0:
        return s
    first = torch.ones(len(s), dtype=torch.bool, device=c.device)
    first[1:] = (s[1:] != s[:-1]).any(dim=1)
    return s[first]


def correspondences(xyz0: torch.Tensor, xyz1: torch.Tensor, nn: torch.Tensor,
                    voxel_size: float) -> torch.Tensor:
    """int64[n0, 7]: (0, floor(p / v), floor(q / v)) of each source voxel's
    point p and its match's point q = xyz1[nn]."""
    p, q = cells(xyz0, voxel_size), cells(xyz1[nn.long()], voxel_size)
    return torch.cat([torch.zeros_like(p[:, :1]), p, q], dim=1)


def offsets(scale: int, device) -> torch.Tensor:
    return torch.tensor(list(itertools.product((-1, 0, 1), repeat=DIM)), dtype=torch.int64,
                        device=device) * scale


class Ids:
    """Mixed-radix ids of points over a span: each axis shifted by its
    least value less ``pad`` and given the span plus twice ``pad`` values,
    so every point within ``pad`` of the span has its own id."""

    def __init__(self, tables: Sequence[torch.Tensor], pad: int):
        allc = torch.cat(list(tables))
        self.lo = allc.min(dim=0).values - pad
        self.radix = allc.max(dim=0).values + pad - self.lo + 1

    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(len(c), dtype=torch.int64, device=c.device)
        for a in range(c.shape[1]):
            out = out * self.radix[a] + (c[:, a] - self.lo[a])
        return out


def offset_map(out_c: torch.Tensor, in_c: torch.Tensor, offs: torch.Tensor,
               ids: Ids) -> torch.Tensor:
    """nbr int64[N_out, K]: the row of ``out + offset`` in the sorted input
    table, or -1."""
    table = ids(in_c)
    nbr = torch.full((len(out_c), len(offs)), -1, dtype=torch.int64, device=out_c.device)
    if len(table) == 0:
        return nbr
    for k in range(len(offs)):
        q = out_c.clone()
        q[:, 1:] += offs[k]
        qk = ids(q)
        pos = torch.searchsorted(table, qk).clamp_max(len(table) - 1)
        nbr[:, k] = torch.where(table[pos] == qk, pos, torch.full_like(pos, -1))
    return nbr


class Pyramid6(NamedTuple):
    tables: List[torch.Tensor]          # level i: points at stride 2^i, sorted
    same: List[torch.Tensor]            # level i: its k3 map
    down: List[Optional[torch.Tensor]]  # level i: gathers level i - 1
    up: List[Optional[torch.Tensor]]    # level i: gathers level i + 1
    conv1: torch.Tensor                 # conv1's k3 map: level 0's


def pyramid(table0: torch.Tensor) -> Pyramid6:
    tables = [table0]
    for i in range(1, NUM_LEVELS):
        s = 1 << i
        c = table0.clone()
        c[:, 1:] = torch.div(c[:, 1:], s, rounding_mode="floor") * s
        tables.append(unique_rows(c))
    ids = Ids(tables, 1 << (NUM_LEVELS - 1))
    dev = table0.device
    same, down, up = [], [], []
    for i in range(NUM_LEVELS):
        t = 1 << i
        same.append(offset_map(tables[i], tables[i], offsets(t, dev), ids))
        down.append(None if i == 0 else
                    offset_map(tables[i], tables[i - 1], offsets(t >> 1, dev), ids))
        up.append(None if i == NUM_LEVELS - 1 else
                  offset_map(tables[i], tables[i + 1], offsets(t, dev), ids))
    return Pyramid6(tables, same, down, up, same[0])


def maps(pyr: Pyramid6) -> List[Tuple[str, torch.Tensor]]:
    """(name, map) of every distinct map, in the program's order: per level
    its k3 map, down map, up map."""
    out = []
    for i in range(NUM_LEVELS):
        out.append((f"same{i}", pyr.same[i]))
        if pyr.down[i] is not None:
            out.append((f"down{i}", pyr.down[i]))
        if pyr.up[i] is not None:
            out.append((f"up{i}", pyr.up[i]))
    return out


# ---- the network -----------------------------------------------------------

def param_specs(m: Dict):
    """Every parameter and buffer of the 6-D network ``m`` (the config
    file's ``model`` group) with the program's state-dict names."""
    ch, tr = m["channels"], m["tr_channels"]
    k3 = 3 ** DIM
    out = []

    def conv(name, k, cin, cout):
        out.append((f"{name}.weight", (k, cin, cout), "weight", k * cin))

    def block(name, c):
        for j in range(2):
            conv(f"{name}.conv{j}", k3, c, c)
            _bn(f"{name}.norm{j}.bn", c, out)

    conv("conv1", m["conv1_kernel_size"] ** DIM, m["in_channels"], ch[0])
    _bn("norm1.bn", ch[0], out)
    block("block1", ch[0])
    for i in range(1, 4):
        conv(f"conv{i + 1}", k3, ch[i - 1], ch[i])
        _bn(f"norm{i + 1}.bn", ch[i], out)
        block(f"block{i + 1}", ch[i])
    conv("conv4_tr", k3, ch[3], tr[3])
    _bn("norm4_tr.bn", tr[3], out)
    block("block4_tr", tr[3])
    conv("conv3_tr", k3, ch[2] + tr[3], tr[2])
    _bn("norm3_tr.bn", tr[2], out)
    block("block3_tr", tr[2])
    conv("conv2_tr", k3, ch[1] + tr[2], tr[1])
    _bn("norm2_tr.bn", tr[1], out)
    block("block2_tr", tr[1])
    out.append(("conv1_tr.weight", (ch[0] + tr[1], tr[0]), "weight", ch[0] + tr[1]))
    out.append(("final.weight", (tr[0], m["out_channels"]), "weight", tr[0]))
    out.append(("final.bias", (m["out_channels"],), "shift", 0))
    return out


def sparse_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                prec: Precision) -> torch.Tensor:
    """out[n] = Σ_k x[nbr[n, k]] @ w[k]: the live entries grouped by
    offset, one product an offset."""
    xr, wr = prec.round(x), prec.round(w)
    out = torch.zeros((nbr.shape[0], w.shape[2]), device=x.device)
    rows, ks = torch.nonzero(nbr >= 0, as_tuple=True)
    order = torch.sort(ks, stable=True).indices
    rows, ks = rows[order], ks[order]
    counts = torch.bincount(ks, minlength=nbr.shape[1]).tolist()
    at = 0
    for k, n in enumerate(counts):
        if n:
            r = rows[at:at + n]
            out.index_add_(0, r, xr[nbr[r, k]] @ wr[k])
            at += n
    return out


def _norm(P, name, x):
    mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]) + P[f"{name}.bias"]


def _block(P, name, x, nbr, prec):
    out = torch.relu(_norm(P, f"{name}.norm0.bn",
                           sparse_conv(x, nbr, P[f"{name}.conv0.weight"], prec)))
    out = _norm(P, f"{name}.norm1.bn", sparse_conv(out, nbr, P[f"{name}.conv1.weight"], prec))
    return torch.relu(out + x)


def logits(P: Dict[str, torch.Tensor], pyr: Pyramid6, prec: Precision) -> torch.Tensor:
    """f32[N0]: the network's logit of each point of ``pyr.tables[0]``."""
    same, down, up = pyr.same, pyr.down, pyr.up
    ones = torch.ones((len(pyr.tables[0]), 1), device=pyr.conv1.device)
    out = sparse_conv(ones, pyr.conv1, P["conv1.weight"], prec)
    s1 = _block(P, "block1", _norm(P, "norm1.bn", out), same[0], prec)
    out = sparse_conv(s1, down[1], P["conv2.weight"], prec)
    s2 = _block(P, "block2", _norm(P, "norm2.bn", out), same[1], prec)
    out = sparse_conv(s2, down[2], P["conv3.weight"], prec)
    s4 = _block(P, "block3", _norm(P, "norm3.bn", out), same[2], prec)
    out = sparse_conv(s4, down[3], P["conv4.weight"], prec)
    out = _block(P, "block4", _norm(P, "norm4.bn", out), same[3], prec)
    out = sparse_conv(out, up[2], P["conv4_tr.weight"], prec)
    out = _block(P, "block4_tr", _norm(P, "norm4_tr.bn", out), same[2], prec)
    out = sparse_conv(torch.cat([out, s4], 1), up[1], P["conv3_tr.weight"], prec)
    out = _block(P, "block3_tr", _norm(P, "norm3_tr.bn", out), same[1], prec)
    out = sparse_conv(torch.cat([out, s2], 1), up[0], P["conv2_tr.weight"], prec)
    out = _block(P, "block2_tr", _norm(P, "norm2_tr.bn", out), same[0], prec)
    out = torch.relu(prec.mm(torch.cat([out, s1], 1), P["conv1_tr.weight"]))
    return (prec.mm(out, P["final.weight"]) + P["final.bias"])[:, 0]


def conv_calls(pyr: Pyramid6, m: Dict):
    """(name, map, n_in, cin, cout) of the forward's sparse convs in the
    order it runs them (conv1 first)."""
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


# ---- weights and the pose ---------------------------------------------------

def weights(logit: torch.Tensor, clip: float) -> torch.Tensor:
    w = torch.sigmoid(logit)
    return torch.where(w >= clip, w, torch.zeros_like(w))


def procrustes(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
               operands: Optional[torch.dtype] = None) -> torch.Tensor:
    """f64[4, 4]: the weighted least-squares rigid motion taking ``src``
    onto ``dst``, by an SVD of the weighted covariance. ``operands`` (the
    control: bfloat16, the step below the float32 the program solves in)
    rounds the points and weights to that type first; the sums stay f64."""
    if operands is not None:
        src, dst, w = src.to(operands), dst.to(operands), w.to(operands)
    s, d, w = src.double(), dst.double(), w.double()
    w = w / w.sum().clamp_min(1e-300)
    ms, md = (w[:, None] * s).sum(0), (w[:, None] * d).sum(0)
    H = ((s - ms) * w[:, None]).T @ (d - md)
    U, _, Vt = torch.linalg.svd(H)
    D = torch.eye(3, dtype=torch.float64, device=s.device)
    D[2, 2] = torch.sign(torch.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    T = torch.eye(4, dtype=torch.float64, device=s.device)
    T[:3, :3], T[:3, 3] = R, md - R @ ms
    return T


def pose_gap(T: torch.Tensor, T_ref: torch.Tensor, pts: torch.Tensor) -> float:
    """m: the largest distance between a point moved by ``T`` and by
    ``T_ref``, over ``pts``."""
    p = pts.double()
    a = p @ T.double()[:3, :3].T + T.double()[:3, 3]
    b = p @ T_ref.double()[:3, :3].T + T_ref.double()[:3, 3]
    return float((a - b).norm(dim=1).max()) if len(p) else 0.0


class Registration(NamedTuple):
    table: torch.Tensor       # int64[n, 7] the sorted 6-D points
    pyr: Pyramid6
    logits: torch.Tensor      # f32[n] in the table's order
    weights: torch.Tensor     # f32[n]
    pose: torch.Tensor        # f64[4, 4]


def register(P, xyz0: torch.Tensor, xyz1: torch.Tensor, nn: torch.Tensor, voxel_size: float,
             clip: float, prec: Precision) -> Registration:
    """The registration of one pair from its correspondences ``nn`` (the
    match of each source voxel)."""
    c = correspondences(xyz0, xyz1, nn, voxel_size)
    order = lex_sort(c)
    pyr = pyramid(c[order])
    z = logits(P, pyr, prec)
    w = weights(z, clip)
    src = xyz0[order]
    dst = xyz1[nn.long()[order]]
    return Registration(c[order], pyr, z, w, procrustes(src, dst, w))
