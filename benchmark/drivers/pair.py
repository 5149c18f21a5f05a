"""3DMatch fragment pairs through ``PairRegistrar``, one caller waiting on
each pose.

Set-up: the seeded weights (``benchlib.weights``) go to the program's
``PairRegistrar(config, state_dict=...)`` and to the reference; the pool of
pairs comes from ``traffic/surface.py`` with the traffic file's
parameters, each with its keypoint keys and RANSAC uniforms drawn on the
device from the seed. Every voxel bucket the pool reaches is called twice
(the graph's eager call, then its capture). A unit is one pair of the pool,
in a seeded order: the call with host arrays in hand (span ``call``), then
its pose and metrics copied to the host (span ``result``).

The check reads the descriptors the timed call produced from the graph's
own output buffer: a forward hook on the program's model keeps, at each
bucket's capture, the model's input table and output, which every replay
of that bucket rewrites in place. ``keep`` copies them for a sample of the
window's pairs drawn from the seed, the largest pair of the pool among
them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchlib import arith, regcheck, weights
from benchlib.harness import Reservoir
from benchlib.pairs import PoolDriver
from benchlib.program import Capture, program_config
from reference import model as ref_model
from reference import voxels as ref_vox
from reference.precision import Precision, full_f32
from traffic import surface


class Driver(PoolDriver):
    # ---- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from imfnet_tpu_torch.pipeline import PairRegistrar

        self.pcfg = program_config(self.cell.config)
        self.P = weights.make(ref_model.param_specs(self.m), self.seed, self.dev)
        self.reg = PairRegistrar(self.pcfg, device=self.dev, state_dict=self.P)
        self.cap = Capture(self.reg.model)
        tr = self.tr
        tr.update(voxel_size=self.pcfg.voxel_size, grid_extent=list(self.pcfg.grid_extent),
                  capacity_divisors=list(self.pcfg.level_capacity_divisors))
        self.pool = surface.pool(self.seed, tr)
        gen = weights.generator(self.seed, self.dev, salt=2)
        self.cov = np.eye(6, dtype=np.float32)
        for q in self.pool:
            q["u"] = tuple(torch.rand(q["n_pad"], generator=gen, device=self.dev)
                           for _ in range(2))
            q["samples"] = torch.rand(self.reg.sample_shape, generator=gen, device=self.dev)
        rng = surface.rng_for(self.seed, 1 << 20)
        self.order = rng.permutation(len(self.pool))
        # the check also sees the first instance of the pool's largest pair
        self.always = max(range(len(self.pool)), key=lambda p: self.pool[p]["n_pad"])
        self.sample = Reservoir(int(self.cell.workload["check"]["pairs"]),
                                surface.rng_for(self.seed, 1 << 21))
        first = {}
        for p, q in enumerate(self.pool):
            first.setdefault(q["n_pad"], p)
        for p in first.values():              # eager call, then the capture
            for _ in range(2):
                self.run_one(p)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def run_one(self, p: int):
        q = self.pool[p]
        return self.reg(q["xyz0"], q["xyz1"], q["image0"], q["image1"], q["T_gt"], self.cov,
                        keypoint_u=q["u"], samples=q["samples"])

    def items(self):
        return range(len(self.pool))

    def snapshot_of(self, p: int, out) -> Dict:
        """What the check compares of pair p's call that returned ``out``:
        the result, and copies of the table and descriptors the call left
        in the model's buffers."""
        rec = self.cap.by_rows[self.pool[p]["n_pad"]]
        return {"out": out, **{k: v.clone() for k, v in rec.items()}}

    def work(self, i: int) -> Dict:
        q = self.pool[self.item_of(i)]
        if "work" not in q:
            q["work"] = self._work(q)
        return q["work"]

    def _work(self, q) -> Dict:
        coords, _ = self._ref_voxels(q)
        pyr = ref_vox.pyramid(coords, 4, self.m["conv1_kernel_size"])
        calls = ref_model.conv_calls(pyr, self.m)
        convs = [arith.conv_stats(name, nbr, n_in, ci, co, "plain" if name == "conv1" else "A")
                 for name, nbr, n_in, ci, co in calls]
        ch, tr = self.m["channels"], self.m["tr_channels"]
        n0 = len(coords)
        h, w = self.pcfg.image_H, self.pcfg.image_W
        t = ((h + 7) // 8) * ((w + 7) // 8)
        m3 = [int((pyr.tables[3][:, 0] == b).sum()) for b in range(2)]
        k = self.pcfg.num_rand_keypoints
        d = self.m["out_channels"]
        return {"convs": convs,
                "dense": [(n0, ch[0] + tr[1], tr[0]), (n0, tr[0], d)],
                "images": [(2, h, w)], "fusion": [(m, t) for m in m3],
                "nn": [(k, k, d), (k, k, d)]}

    # ---- the check ---------------------------------------------------------
    def release(self) -> None:
        del self.reg, self.cap
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_voxels(self, q):
        xyz = torch.from_numpy(np.concatenate([q["xyz0"], q["xyz1"]])).to(self.dev)
        batch = torch.cat([torch.zeros(len(q["xyz0"]), dtype=torch.int64),
                           torch.ones(len(q["xyz1"]), dtype=torch.int64)]).to(self.dev)
        coords, first = ref_vox.voxelize(xyz, batch, self.pcfg.voxel_size,
                                         tuple(self.pcfg.grid_extent))
        return coords, xyz[first]

    def _sides(self, q, coords, xyz_down, feats) -> List[regcheck.Side]:
        n_rows = q["n_pad"]
        nv = len(coords)
        n0 = int((coords[:, 0] == 0).sum())
        r = torch.arange(n_rows, device=self.dev)
        X = regcheck.pad_rows(xyz_down, n_rows)
        F = regcheck.pad_rows(feats.float(), n_rows)
        return [regcheck.Side(X, F, r < n0, q["u"][0]),
                regcheck.Side(X, F, (r >= n0) & (r < nv), q["u"][1])]

    def _args(self, q):
        return dict(k=self.pcfg.num_rand_keypoints, samples=q["samples"],
                    T_gt=torch.as_tensor(q["T_gt"], device=self.dev),
                    ransac_thresh=self.pcfg.voxel_size * 1.5,
                    inlier_thresh=self.pcfg.inlier_thresh)

    def reference_of(self, p: int, P, prec: Precision):
        """(coords, xyz_down, descriptors) of pair p, worked out by the
        reference."""
        q = self.pool[p]
        coords, xyz_down = self._ref_voxels(q)
        images = torch.from_numpy(np.stack([q["image0"], q["image1"]])).to(self.dev)
        with full_f32():
            feats = regcheck.descriptors(P, self.m, coords, images, prec)
        return coords, xyz_down, feats

    def judge_of(self, p: int, snap: Dict, ref) -> Dict[str, float]:
        q = self.pool[p]
        coords, xyz_down, feats = ref
        nv = int(snap["num_valid"])
        row = {"voxels_differ": regcheck.voxels_differ(snap["coords"][:nv], coords)}
        if row["voxels_differ"]:
            return {**row, "desc_gap": float("inf"), "fitness_gap": float("inf"),
                    "mutual_gap": float("inf")}
        row["desc_gap"] = regcheck.desc_gap(snap["feats"][:nv], feats)
        row.update(regcheck.judge(self._sides(q, coords, xyz_down, snap["feats"][:nv]),
                                  snap["out"], **self._args(q)))
        return row

    def control(self, p: int, prec: Precision) -> Dict:
        """The reference in the program's place at ``prec``, as a snapshot."""
        q = self.pool[p]
        coords, xyz_down, feats = self.reference_of(p, regcheck.ref_params(self.P), prec)
        out = regcheck.control_result(self._sides(q, coords, xyz_down, feats), **self._args(q),
                                      prec=prec)
        return {"out": out, "coords": coords, "num_valid": torch.tensor(len(coords)),
                "feats": feats}
