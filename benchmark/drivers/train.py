"""3DMatch training steps through the graphed training step, one step at a
time, as ``Trainer._train_epoch`` takes them.

Set-up: the seeded weights go to the program's training model
(``build_model_from_config``, ``load_state_dict``), its train state
(``create_train_state``: fused SGD, momentum 0.8, weight decay 1e-4) and
``make_graphed_train_step``; the pool of host batches (``batch_size``
pairs each, from ``traffic/surface.py``, voxelized there, collated by the
program's ``collate_pairs`` on the host, padded to ``max_points`` a side).
The first three steps run in set-up on batches 0, 1, 2 (the signature's
eager call, its capture, a replay) with loss draws from a seeded generator
on the card; the check keeps their losses, the momentum buffers after step
1 and the parameters after step 3. A unit: ``batch_to_device`` (the
staging ring), the step with the generator (its draws made outside the
graph), span ``call``; the loss read to the host, span ``result``.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchlib import arith, weights
from benchlib.program import program_config
from reference import model as ref_model
from reference import train as ref_train
from reference import voxels as ref_vox
from reference.precision import Precision, full_f32
from traffic import kitti, surface

REFERENCE_STEPS = 3


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.m = cell.config["model"]
        self.tr = dict(cell.workload["traffic"])
        self._work: Dict[int, Dict] = {}

    def setup(self) -> None:
        from imfnet_tpu_torch.data.collate import VoxelizedPair, collate_pairs
        from imfnet_tpu_torch.train.state import create_train_state
        from imfnet_tpu_torch.train.step import loss_draws, make_graphed_train_step
        from imfnet_tpu_torch.train.trainer import build_model_from_config

        self.pcfg = c = program_config(self.cell.config)
        self.P = weights.make(ref_model.param_specs(self.m), self.seed, self.dev)
        model = build_model_from_config(c).to(self.dev)
        model.load_state_dict(self.P)
        self.state = create_train_state(model, c, int(self.tr["steps_per_epoch"]))
        self.step = make_graphed_train_step(c)
        self.loss_draws = loss_draws
        self.tr.update(voxel_size=c.voxel_size, grid_extent=list(c.grid_extent),
                       capacity_divisors=list(c.level_capacity_divisors))
        bs = c.batch_size
        pairs = surface.pool(self.seed, self.tr)
        self.samples, self.host = [], []
        for b in range(len(pairs) // bs):
            group = []
            for q in pairs[b * bs:(b + 1) * bs]:
                c0, x0 = kitti.voxelize(q["xyz0"], c.voxel_size)
                c1, x1 = kitti.voxelize(q["xyz1"], c.voxel_size)
                ones = [np.ones((len(x), 1), np.float32) for x in (x0, x1)]
                # training pairs carry the pose that maps fragment 0 into 1
                group.append(VoxelizedPair(c0, x0, ones[0], c1, x1, ones[1], q["image0"],
                                           q["image1"], np.linalg.inv(q["T_gt"]).astype(np.float32)))
            self.samples.append(group)
            self.host.append(collate_pairs(group, c.max_points, grid_extent=c.grid_extent,
                                           device="cpu"))
        self.gen = weights.generator(self.seed, self.dev, salt=3)
        self.losses, self.pos_losses, self.draws = [], [], []
        # the first step runs eagerly: its two forwards' tables and
        # descriptors are copied as they come out, then the hook goes
        seen = []
        hook = self.state.model.register_forward_hook(
            lambda mod, inputs, out: seen.append((inputs[0].coords[:int(inputs[0].num_valid)]
                                                  .long().clone(), out.detach().clone())))
        for s in range(REFERENCE_STEPS):
            batch = self._staged(s)
            draws = self.loss_draws(c, batch, self.gen)
            self.draws.append([d.clone() for d in draws])
            _, metrics = self.step(self.state, batch, draws=draws)
            self.losses.append(float(metrics["loss"]))
            self.pos_losses.append(float(metrics["pos_loss"]))
            if s == 0:
                hook.remove()
                self.first_feats = seen[-2:]
                opt = self.state.optimizer
                bufs = {n: opt.state[p].get("momentum_buffer")
                        for n, p in self.state.model.named_parameters()}
                self.bufs1 = {n: None if b is None else b.clone() for n, b in bufs.items()}
        self.after = {n: p.detach().clone() for n, p in self.state.model.named_parameters()}
        self.next = REFERENCE_STEPS
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _staged(self, b: int):
        from imfnet_tpu_torch.train.trainer import batch_to_device
        return batch_to_device(self.host[b % len(self.host)], self.dev)

    def unit(self, i: int, spans) -> float:
        t0 = time.perf_counter()
        with spans("call"):
            batch = self._staged(self.next)
            _, metrics = self.step(self.state, batch, generator=self.gen)
        with spans("result"):
            float(metrics["loss"])
        self.next += 1
        return time.perf_counter() - t0

    def keep(self, i: int) -> None:
        """Nothing: the check follows the steps set-up took."""

    def work(self, i: int) -> Dict:
        b = (REFERENCE_STEPS + i) % len(self.host)
        if b not in self._work:
            self._work[b] = self._work_of(b)
        return self._work[b]

    def _work_of(self, b: int) -> Dict:
        convs, dense, fusion, nn = [], [], [], []
        ch, tr = self.m["channels"], self.m["tr_channels"]
        h, w = self.pcfg.image_H, self.pcfg.image_W
        sides = self._sides(b)
        for s in sides:
            pyr = ref_vox.pyramid(s.coords, 4, self.m["conv1_kernel_size"])
            inverse = {id(pyr.down[i]): pyr.up[i - 1] for i in range(1, 4)}
            inverse.update({id(pyr.up[i]): pyr.down[i + 1] for i in range(3)})
            for name, nbr, n_in, ci, co in ref_model.conv_calls(pyr, self.m):
                convs.append(arith.conv_stats(name, nbr, n_in, ci, co, "A"))
                if name != "conv1":          # dX through the map's exact inverse
                    inv = inverse.get(id(nbr), nbr)
                    convs.append(arith.conv_stats(f"{name}.dX", inv, len(nbr), co, ci, "dX"))
            n = len(s.coords)
            dense += [(n, ch[0] + tr[1], tr[0]), (n, tr[0], self.m["out_channels"])]
            for bi in range(len(s.images)):
                fusion.append((int((pyr.tables[3][:, 0] == bi).sum()), ((h + 7) // 8) * ((w + 7) // 8)))
        for bi in range(len(sides[0].images)):
            n0 = int((sides[0].coords[:, 0] == bi).sum())
            n1 = int((sides[1].coords[:, 0] == bi).sum())
            nn.append((n0, n1, 3))
        return {"convs": [c for c in convs if c["path"] == "A"],
                "dx": [c for c in convs if c["path"] == "dX"],
                "dense": dense, "images": [(len(s.images), h, w) for s in sides],
                "fusion": fusion, "nn": nn, "passes": 3}

    def release(self) -> None:
        del self.step, self.state
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ---------------------------------------------------------
    def _sides(self, b: int):
        out = []
        group = self.samples[b % len(self.samples)]
        pairs = range(len(group))
        for side in (0, 1):
            c = torch.cat([torch.cat([torch.full((len(getattr(group[i], f"coords{side}")), 1), k),
                                      torch.from_numpy(getattr(group[i], f"coords{side}")
                                                       .astype(np.int64))], 1)
                           for k, i in enumerate(pairs)]).to(self.dev)
            x = torch.cat([torch.from_numpy(getattr(group[i], f"xyz{side}"))
                           for i in pairs]).to(self.dev)
            order = torch.argsort(ref_vox.keys(c))
            imgs = torch.from_numpy(np.stack([getattr(group[i], f"image{side}")
                                              for i in pairs])).to(self.dev)
            out.append(ref_train.TrainSide(c[order], x[order], imgs, self.pcfg.max_points))
        return tuple(out)

    def _consts(self) -> Dict:
        c = self.pcfg
        bs = c.batch_size
        return {"radius": c.voxel_size * c.positive_pair_search_voxel_size_multiplier,
                "num_pos": c.num_pos_per_batch * bs, "num_hn": c.num_hn_samples_per_batch * bs,
                "pos_thresh": c.pos_thresh, "neg_thresh": c.neg_thresh,
                "neg_weight": c.neg_weight}

    def reference_steps(self, prec: Precision, fault: Optional[str] = None) -> Dict:
        """The reference's first three steps from the seeded weights on the
        same batches and draws: losses, first gradients, parameters after.
        ``fault`` plants one in the reference: "half", half of the batch
        left out, the loss's means taken over the first pair's rows alone
        (the forwards see the whole batch); "unchanged", steps that leave
        the state as it was (no update, no optimizer state)."""
        c = self.pcfg
        params = {n: self.P[n].detach().float().clone().requires_grad_(True)
                  for n in self.after}
        P = dict(self.P, **params)
        bufs, losses, pos_losses, first, feats = {}, [], [], None, None
        with full_f32():
            for s in range(REFERENCE_STEPS):
                sides = self._sides(s)
                T = torch.stack([torch.from_numpy(np.asarray(g.T_gt)) for g in
                                 self.samples[s]]).to(self.dev)
                loss, pos, f = ref_train.loss(P, self.m, sides, T, self.draws[s],
                                              self._consts(), prec,
                                              pairs_in_loss=len(T) // 2 if fault == "half"
                                              else None)
                feats = feats or [(sd.coords, x.detach()) for sd, x in zip(sides, f)]
                grads = torch.autograd.grad(loss, list(params.values()))
                grads = dict(zip(params, grads))
                first = first or {k: g.detach().clone() for k, g in grads.items()}
                losses.append(float(loss.detach()))
                pos_losses.append(float(pos.detach()))
                if fault != "unchanged":
                    ref_train.sgd_step(params, grads, bufs, c.lr, c.momentum, c.weight_decay)
        if fault == "unchanged":
            first = {k: torch.zeros_like(g) for k, g in first.items()}
        return {"losses": losses, "pos_losses": pos_losses, "grads": first, "feats": feats,
                "after": {k: v.detach() for k, v in params.items()}}

    def program_steps(self) -> Dict:
        wd = self.pcfg.weight_decay
        # the first gradient as the optimizer got it: its momentum buffer
        # after one step less the weight decay; none where it has no buffer
        return {"losses": self.losses, "pos_losses": self.pos_losses,
                "feats": self.first_feats,
                "grads": {k: (b - wd * self.P[k].float() if b is not None
                              else torch.zeros_like(self.P[k].float()))
                          for k, b in self.bufs1.items()},
                "after": self.after}

    def compare(self, got: Dict, ref: Dict) -> Dict[str, float]:
        """desc_gap_first: the largest L2 distance between a voxel's
        descriptor in the first step's forwards and the reference's (inf
        where the voxels differ); loss_gap_first: the relative difference
        of the first step's loss,
        pos_gap_first of its positive part; loss_gap: the largest over the
        steps. Per leaf, the gap between the norms of the first gradient (of the
        parameters' change over the steps), over the reference's norm of
        that leaf or of the median leaf, whichever is larger: grad_gap and
        delta_gap by the worst leaf, grad_gap_median and delta_gap_median
        by the median leaf; grad_diff_median and delta_diff_median take the
        norm of the difference in place of the gap of norms. Leaves whose
        reference gradient is under a thousandth of the median leaf's are
        left out."""
        gn = {k: float(v.norm()) for k, v in ref["grads"].items()}
        med_g = statistics.median(gn.values())
        keep = [k for k in gn if gn[k] >= 1e-3 * med_g]
        dr = {k: float((ref["after"][k] - self.P[k].float()).norm()) for k in keep}
        dp = {k: float((got["after"][k].float() - self.P[k].float()).norm()) for k in keep}
        med_d = statistics.median(dr.values())
        grad = [abs(float(got["grads"][k].norm()) - gn[k]) / max(gn[k], med_g) for k in keep]
        delta = [abs(dp[k] - dr[k]) / max(dr[k], med_d) for k in keep]
        grad_diff = [float((got["grads"][k].float() - ref["grads"][k]).norm()) / max(gn[k], med_g)
                     for k in keep]
        delta_diff = [float((got["after"][k].float() - ref["after"][k]).norm()) / max(dr[k], med_d)
                      for k in keep]
        rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got["losses"], ref["losses"])]
        pos = abs(got["pos_losses"][0] - ref["pos_losses"][0]) / max(abs(ref["pos_losses"][0]),
                                                                       1e-12)
        desc = 0.0
        for (c_got, f_got), (c_ref, f_ref) in zip(got["feats"], ref["feats"]):
            same = c_got.shape == c_ref.shape and torch.equal(c_got.cpu(), c_ref.cpu())
            desc = max(desc, float((f_got[:len(f_ref)].float() - f_ref).norm(dim=1).max())
                       if same else float("inf"))
        return {"desc_gap_first": desc, "loss_gap_first": rel[0], "pos_gap_first": pos,
                "loss_gap": max(rel),
                "grad_gap": max(grad), "delta_gap": max(delta),
                "grad_gap_median": statistics.median(grad),
                "delta_gap_median": statistics.median(delta),
                "grad_diff_median": statistics.median(grad_diff),
                "delta_diff_median": statistics.median(delta_diff)}

    def check(self):
        row = self.compare(self.program_steps(), self.reference_steps(Precision("f32")))
        return [(k, row[k], lim) for k, lim in self.cell.workload["limits"].items()]
