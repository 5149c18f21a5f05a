"""KITTI scan pairs through eval-kitti's pair graph, one caller waiting on
each pose.

Set-up: the seeded weights go to the program's model (``pipeline
.init_model`` with the configuration, then ``load_state_dict``) and to the
reference; the pool of scan pairs from ``traffic/kitti.py`` is voxelized
there and collated on the host by the program's ``collate_pairs`` (one
pair a batch, padded to ``max_points`` a side, as its test loader makes
them). The pair graph is called twice on the first pair (eager call, then
capture). A unit: ``batch_to_device`` and ``make_eval_pair(model,
config)(i, batch)`` (both forwards and pyramids, keypoints at every voxel,
NN both ways, RANSAC, metrics; its draws from a generator seeded with the
pair's number i), span ``call``; then its pose and metrics on the host,
span ``result``.

The check reads both sides' descriptors from the graph's output buffers
(the model's forward hook at the capture keeps them; see ``drivers/pair``)
and compares the voxels and descriptors with the reference's. It reads the
match layer's output the same way: the registration's two nearest-neighbour
calls, recorded at the capture (``benchlib.program.NNCapture``), hold the
keypoints' descriptors and kernel B's indices of every replay; the
reference finds each valid keypoint's nearest valid neighbour over those
descriptors again (``regcheck.nn_wrong``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchlib import arith, regcheck, weights
from benchlib.harness import Reservoir
from benchlib.pairs import PoolDriver
from benchlib.program import Capture, NNCapture, program_config
from reference import model as ref_model
from reference import registration as ref_reg
from reference import voxels as ref_vox
from reference.precision import Precision, full_f32
from traffic import kitti, surface


class Driver(PoolDriver):
    def setup(self) -> None:
        from imfnet_tpu_torch.data.collate import VoxelizedPair, collate_pairs
        from imfnet_tpu_torch.eval.kitti import make_eval_pair
        from imfnet_tpu_torch.pipeline import init_model

        self.pcfg = c = program_config(self.cell.config)
        self.P = weights.make(ref_model.param_specs(self.m), self.seed, self.dev)
        model = init_model(c).to(self.dev)
        model.load_state_dict(self.P)
        self.model = model.eval()
        self.cap = Capture(self.model)
        self.nn = NNCapture()
        self.eval_pair = make_eval_pair(self.model, c)
        self.tr.update(voxel_size=c.voxel_size)
        self.pool = kitti.pool(self.seed, self.tr)
        base = int(surface.rng_for(self.seed, 1 << 22).integers(0, 1 << 40))
        self.batches = []
        for p, q in enumerate(self.pool):
            n = lambda a: np.ones((len(a), 1), np.float32)  # noqa: E731
            s = VoxelizedPair(q["coords0"], q["xyz0"], n(q["xyz0"]), q["coords1"], q["xyz1"],
                              n(q["xyz1"]), q["image0"], q["image1"], q["T_gt"])
            self.batches.append(collate_pairs([s], c.max_points, grid_extent=c.grid_extent,
                                              device="cpu"))
            q["draw"] = base + p       # the pair's number: its draws' generator seed
        rng = surface.rng_for(self.seed, 1 << 20)
        self.order = rng.permutation(len(self.pool))
        self.sample = Reservoir(int(self.cell.workload["check"]["pairs"]),
                                surface.rng_for(self.seed, 1 << 21))
        for _ in range(2):                         # eager call, then the capture
            self.run_one(0)
        self.static = self.cap.calls[-2:]
        self.static_nn = self.nn.calls[-2:]
        torch.cuda.synchronize() if self.dev.type == "cuda" else None

    def run_one(self, p: int):
        from imfnet_tpu_torch.train.trainer import batch_to_device
        return self.eval_pair(self.pool[p]["draw"], batch_to_device(self.batches[p], self.dev))

    def items(self):
        return range(len(self.pool))

    def snapshot_of(self, p: int, out) -> Dict:
        on_card = self.dev.type == "cuda"
        calls = self.static if on_card else self.cap.calls[-2:]
        nn01, nn10 = self.static_nn if on_card else self.nn.calls[-2:]
        return {"out": out, "sides": [{k: v.clone() for k, v in rec.items()} for rec in calls],
                # keypoint descriptors and validity of each side, both indices
                "kd": [nn01["queries"].clone(), nn01["refs"].clone()],
                "ok": [nn10["ref_valid"].clone(), nn01["ref_valid"].clone()],
                "idx": [nn01["idx"].clone(), nn10["idx"].clone()]}

    def _tables(self, q):
        out = []
        for s in (0, 1):
            c = torch.from_numpy(q[f"coords{s}"].astype(np.int64)).to(self.dev)
            c4 = torch.cat([torch.zeros_like(c[:, :1]), c], 1)
            order = torch.argsort(ref_vox.keys(c4))
            out.append((c4[order], torch.from_numpy(q[f"xyz{s}"]).to(self.dev)[order]))
        return out

    def work(self, i: int) -> Dict:
        q = self.pool[self.item_of(i)]
        if "work" not in q:
            convs, dense, fusion, nv = [], [], [], []
            ch, tr = self.m["channels"], self.m["tr_channels"]
            h, w = self.pcfg.image_H, self.pcfg.image_W
            for coords, _ in self._tables(q):
                pyr = ref_vox.pyramid(coords, 4, self.m["conv1_kernel_size"])
                convs += [arith.conv_stats(n, nbr, n_in, ci, co, "plain" if n == "conv1" else "A")
                          for n, nbr, n_in, ci, co in ref_model.conv_calls(pyr, self.m)]
                dense += [(len(coords), ch[0] + tr[1], tr[0]),
                          (len(coords), tr[0], self.m["out_channels"])]
                fusion.append((len(pyr.tables[3]), ((h + 7) // 8) * ((w + 7) // 8)))
                nv.append(len(coords))
            d = self.m["out_channels"]
            q["work"] = {"convs": convs, "dense": dense, "images": [(1, h, w), (1, h, w)],
                         "fusion": fusion, "nn": [(nv[0], nv[1], d), (nv[1], nv[0], d)]}
        return q["work"]

    def release(self) -> None:
        self.nn.close()
        del self.eval_pair, self.model, self.cap, self.static, self.nn, self.static_nn
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_of(self, p: int, P, prec: Precision):
        q = self.pool[p]
        out = []
        with full_f32():
            for s, (coords, xyz) in enumerate(self._tables(q)):
                img = torch.from_numpy(q[f"image{s}"][None]).to(self.dev)
                out.append((coords, xyz, regcheck.descriptors(P, self.m, coords, img, prec)))
        return out

    def judge_of(self, p: int, snap: Dict, ref) -> Dict[str, float]:
        row = {"voxels_differ": 0, "desc_gap": 0.0, "nn_wrong": 0}
        for side, (coords, _, f) in zip(snap["sides"], ref):
            nv = int(side["num_valid"])
            row["voxels_differ"] += regcheck.voxels_differ(side["coords"][:nv], coords)
            row["desc_gap"] = (max(row["desc_gap"], regcheck.desc_gap(side["feats"][:nv], f))
                               if not row["voxels_differ"] else float("inf"))
        if "idx" in snap:
            (kd0, kd1), (ok0, ok1) = snap["kd"], snap["ok"]
            with full_f32():
                row["nn_wrong"] = (regcheck.nn_wrong(kd0, kd1, ok0, ok1, snap["idx"][0])
                                   + regcheck.nn_wrong(kd1, kd0, ok1, ok0, snap["idx"][1]))
        return row

    def control(self, p: int, prec: Precision) -> Dict:
        """The reference's descriptors at ``prec`` in the program's place,
        and its nearest neighbours over them at ``prec``."""
        ref = self.reference_of(p, regcheck.ref_params(self.P), prec)
        f0, f1 = ref[0][2], ref[1][2]
        ok = [torch.ones(len(f), dtype=torch.bool, device=f.device) for f in (f0, f1)]
        with full_f32():
            idx = [ref_reg.nearest(f0, f1, ok[1], prec), ref_reg.nearest(f1, f0, ok[0], prec)]
        return {"sides": [{"coords": c, "num_valid": torch.tensor(len(c)), "feats": f}
                          for c, _, f in ref],
                "kd": [f0, f1], "ok": ok, "idx": idx}
