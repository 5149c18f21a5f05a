"""3DMatch fragments through the bucketed extractor, one caller waiting on
each fragment's descriptors, as ``generate-desc`` extracts them.

Set-up: the seeded weights go to the program's model (``pipeline
.init_model``, ``load_state_dict``) and to the reference; the fragments come
from ``traffic/surface.py``, one a slot of the traffic file, in host
memory, with no file read. Every fragment is extracted twice (each signature's
eager call, then its capture). A unit: ``pad_points_bucketed`` and
``make_bucketed_extractor(model, config=...)(raw, n_raw, image)``, whose
descriptors and points come back as host arrays (span ``call``). The check
compares those arrays.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from benchlib import arith, regcheck, weights
from benchlib.harness import Reservoir
from benchlib.pairs import PoolDriver
from benchlib.program import program_config
from reference import model as ref_model
from reference import voxels as ref_vox
from reference.precision import Precision, full_f32
from traffic import surface


class Driver(PoolDriver):
    def setup(self) -> None:
        from imfnet_tpu_torch.eval.extract import make_bucketed_extractor, pad_points_bucketed
        from imfnet_tpu_torch.pipeline import init_model

        self.pad = pad_points_bucketed
        self.pcfg = c = program_config(self.cell.config)
        self.P = weights.make(ref_model.param_specs(self.m), self.seed, self.dev)
        model = init_model(c).to(self.dev)
        model.load_state_dict(self.P)
        self.model = model.eval()
        self.extract = make_bucketed_extractor(self.model, config=c)
        self.tr.update(voxel_size=c.voxel_size, grid_extent=list(c.grid_extent),
                       capacity_divisors=list(c.level_capacity_divisors))
        self.frags = surface.fragments(self.seed, self.tr)
        self.order = surface.rng_for(self.seed, 1 << 20).permutation(len(self.frags))
        self.sample = Reservoir(int(self.cell.workload["check"]["fragments"]),
                                surface.rng_for(self.seed, 1 << 21))
        for f in range(len(self.frags)):           # each signature's eager call, then capture
            for _ in range(2):
                self.run_one(f)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def run_one(self, f: int):
        fr = self.frags[f]
        raw, n_raw = self.pad(fr["xyz"])
        return self.extract(raw, n_raw, fr["image"][None])

    def items(self):
        return range(len(self.frags))

    def snapshot_of(self, f: int, out) -> Dict:
        return {"xyz_down": out[0], "feats": out[1]}

    def unit(self, i: int, spans) -> float:
        """The call, whose descriptors come back as host arrays (span
        ``call``)."""
        f = self.item_of(i)
        t0 = time.perf_counter()
        with spans("call"):
            self.last = (f, self.run_one(f))
        return time.perf_counter() - t0

    def _table(self, fr):
        xyz = torch.from_numpy(fr["xyz"]).to(self.dev)
        coords, first = ref_vox.voxelize(xyz, torch.zeros(len(xyz), dtype=torch.int64,
                                                          device=self.dev),
                                         self.pcfg.voxel_size, tuple(self.pcfg.grid_extent))
        return coords, xyz[first]

    def work(self, i: int) -> Dict:
        fr = self.frags[self.item_of(i)]
        if "work" not in fr:
            coords, _ = self._table(fr)
            pyr = ref_vox.pyramid(coords, 4, self.m["conv1_kernel_size"])
            ch, tr = self.m["channels"], self.m["tr_channels"]
            h, w = self.pcfg.image_H, self.pcfg.image_W
            n = len(coords)
            fr["work"] = {
                "convs": [arith.conv_stats(nm, nbr, n_in, ci, co,
                                           "plain" if nm == "conv1" else "A")
                          for nm, nbr, n_in, ci, co in ref_model.conv_calls(pyr, self.m)],
                "dense": [(n, ch[0] + tr[1], tr[0]), (n, tr[0], self.m["out_channels"])],
                "images": [(1, h, w)],
                "fusion": [(len(pyr.tables[3]), ((h + 7) // 8) * ((w + 7) // 8))],
                "nn": []}
        return fr["work"]

    def release(self) -> None:
        del self.extract, self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_of(self, f: int, P, prec: Precision):
        fr = self.frags[f]
        coords, xyz_down = self._table(fr)
        img = torch.from_numpy(fr["image"][None]).to(self.dev)
        with full_f32():
            return xyz_down, regcheck.descriptors(P, self.m, coords, img, prec)

    def judge_of(self, f: int, snap: Dict, ref) -> Dict[str, float]:
        xyz_down, feats = ref
        got = torch.as_tensor(snap["xyz_down"], device=self.dev)
        n = min(len(got), len(xyz_down))
        differ = int((got[:n] != xyz_down[:n]).any(dim=1).sum()) + abs(len(got) - len(xyz_down))
        gap = (regcheck.desc_gap(torch.as_tensor(snap["feats"], device=self.dev), feats)
               if not differ else float("inf"))
        return {"voxels_differ": differ, "desc_gap": gap}

    def control(self, f: int, prec: Precision) -> Dict:
        xyz_down, feats = self.reference_of(f, regcheck.ref_params(self.P), prec)
        return {"xyz_down": xyz_down, "feats": feats}
