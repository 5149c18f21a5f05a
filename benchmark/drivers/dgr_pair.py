"""Deep Global Registration over KITTI-like scan pairs, one caller waiting
on each pose.

Set-up: the seeded weights of the 6-D inlier network go to the program's
``eval.dgr.DGRRegistrar`` (``load_state_dict``) and to the reference; the
pool of scan pairs comes from ``traffic/kitti.py`` with descriptors from
``traffic/dgr.py``. The registrar is called twice on the first pair (eager
call, then the capture of its graph). A unit: ``registrar(xyz0, feats0,
xyz1, feats1)`` with the host arrays in hand, pose, weights and Σw on the
host (span ``call``).

What the check compares of a call is read from the graph's own buffers: a
forward hook on the network keeps, at the capture, its input table, the
pyramid's maps and its logits, and ``benchlib.program.NNCapture`` the
nearest-neighbour call's descriptors, validity and indices; every replay
rewrites them. A unit keeps its host result alone; once the window has
closed (``release``), each kept pair is called again and its buffers are
copied, its pose and weights held to the kept ones bit for bit. The
reference works out the 6-D points, maps, logits, weights and pose again
from the program's correspondences (``reference.dgr``; the
correspondences themselves are judged by ``nn_wrong``):

- ``voxels_differ``: 6-D points of the program's table unlike the
  reference's, row for row, plus the difference in count (exact: 0);
- ``maps_differ``: entries of the program's maps unlike the reference's,
  over every map, padding rows included (exact: 0);
- ``nn_wrong``: valid source voxels whose match is not a nearest valid
  target descriptor (``regcheck.nn_wrong``; exact: 0);
- ``logit_gap``: the largest |logit - the reference's| over the
  correspondences, over the spread (largest less least) of the
  reference's logits; inf where the rerun's weights differ from the
  timed call's;
- ``pose_gap`` (m): the program's pose against the reference's float64
  solve on the program's own weights, as the largest distance between
  the source points each moves;
- ``pose_gap_ref`` (m): the same against the reference's pose from its
  own weights.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchlib import dgr_arith, regcheck, weights
from benchlib.harness import Reservoir
from benchlib.pairs import PoolDriver
from benchlib.program import NNCapture, program_config
from reference import dgr as ref_dgr
from reference.precision import Precision, full_f32
from traffic import dgr, surface


class Driver(PoolDriver):
    def setup(self) -> None:
        from imfnet_tpu_torch.eval.dgr import DGRRegistrar

        self.pcfg = c = program_config(self.cell.config)
        self.clip = float(self.cell.config["clip_weight_thresh"])
        self.P = weights.make(ref_dgr.param_specs(self.m), self.seed, self.dev)
        self.reg = DGRRegistrar(c, device=self.dev, state_dict=self.P,
                                clip_weight_thresh=self.clip)
        self.seen: List = []
        self.reg.model.register_forward_hook(
            lambda mod, inputs, out: self.seen.append((inputs[0], inputs[1], out)))
        self.nn = NNCapture()
        self.tr.update(voxel_size=c.voxel_size)
        self.pool = dgr.pool(self.seed, self.tr)
        rng = surface.rng_for(self.seed, 1 << 20)
        self.order = rng.permutation(len(self.pool))
        self.sample = Reservoir(int(self.cell.workload["check"]["pairs"]),
                                surface.rng_for(self.seed, 1 << 21))
        for _ in range(2):                         # eager call, then the capture
            self.run_one(0)
        self.static = self.seen[-1]
        self.static_nn = self.nn.calls[-1]
        self.snaps: Dict[int, Dict] = {}
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def run_one(self, p: int) -> Dict[str, np.ndarray]:
        q = self.pool[p]
        return self.reg(q["xyz0"], q["feats0"], q["xyz1"], q["feats1"])

    def items(self):
        return range(len(self.pool))

    def unit(self, i: int, spans) -> float:
        """The registrar's call with host arrays in hand, its result on the
        host (span ``call``)."""
        p = self.item_of(i)
        t0 = time.perf_counter()
        with spans("call"):
            out = self.run_one(p)
        self.last = (p, out)
        return time.perf_counter() - t0

    def keep(self, i: int) -> None:
        p, out = self.last
        self.sample.offer(i, lambda: {"p": p, "out": out})

    def snapshot_of(self, p: int, out) -> Dict:
        """Copies of the buffers the call just wrote: the table, the maps
        (as their live entries), the logits, the NN call's tensors."""
        on_card = self.dev.type == "cuda"
        sv, pyr, z = self.static if on_card else self.seen[-1]
        call = self.static_nn if on_card else self.nn.calls[-1]
        n = int(sv.num_valid)
        maps = [m for lv in pyr.levels for m in (lv.k3_same, lv.down, lv.up) if m is not None]
        return {"out": out, "table": sv.coords[:n].long().clone(),
                "maps": [(m >= 0).nonzero() for m in maps],
                "map_vals": [m[m >= 0] for m in maps],
                "map_rows": [m.shape[0] for m in maps],
                "logits": z[:n, 0].float().clone(),
                "q": call["queries"].clone(), "r": call["refs"].clone(),
                "q_ok": torch.arange(len(call["queries"]), device=self.dev)
                < len(self.pool[p]["xyz0"]),
                "r_ok": call["ref_valid"].clone(), "idx": call["idx"].clone()}

    def release(self) -> None:
        """Each kept pair called again, after the window, for its buffers."""
        for kept in self.sample.kept:
            p = kept["p"]
            if p in self.snaps:
                continue
            out = self.run_one(p)
            snap = self.snapshot_of(p, out)
            snap["same"] = all(np.array_equal(out[k], kept["out"][k]) for k in out)
            snap["out"] = kept["out"]
            self.snaps[p] = snap
        self.nn.close()
        del self.reg, self.static, self.static_nn, self.seen
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        P = regcheck.ref_params(self.P)
        rows = [self.judge_of(p, s, self.reference_of(p, P, Precision("f32")))
                for p, s in self.snaps.items()]
        return regcheck.worst(rows, self.cell.workload["limits"])

    def work(self, i: int) -> Dict:
        q = self.pool[self.item_of(i)]
        if "work" not in q:
            nn = torch.from_numpy(self._nn(q)).to(self.dev)
            ref = ref_dgr.pyramid(ref_dgr.unique_rows(ref_dgr.correspondences(
                self._t(q["xyz0"]), self._t(q["xyz1"]), nn, self.pcfg.voxel_size)))
            q["work"] = dgr_arith.work(ref, self.m, len(q["xyz0"]), len(q["xyz1"]),
                                       int(self.cell.config["descriptor_dim"]))
        return q["work"]

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.dev)

    def _nn(self, q) -> np.ndarray:
        """Each source voxel's nearest target descriptor (the reference's)."""
        ok = torch.ones(len(q["feats1"]), dtype=torch.bool, device=self.dev)
        with full_f32():
            return ref_dgr_nearest(self._t(q["feats0"]), self._t(q["feats1"]), ok)

    def reference_of(self, p: int, P, prec: Precision):
        return None     # worked out in judge_of, from the program's correspondences

    def judge_of(self, p: int, snap: Dict, ref) -> Dict[str, float]:
        q = self.pool[p]
        n0 = len(q["xyz0"])
        nn = snap["idx"][:n0].long()
        with full_f32():
            reg = ref_dgr.register(regcheck.ref_params(self.P), self._t(q["xyz0"]),
                                   self._t(q["xyz1"]), nn, self.pcfg.voxel_size, self.clip,
                                   Precision("f32"))
            row = {"nn_wrong": regcheck.nn_wrong(snap["q"], snap["r"], snap["q_ok"],
                                                 snap["r_ok"], snap["idx"])}
        row["voxels_differ"] = regcheck.voxels_differ(snap["table"], reg.table)
        row["maps_differ"] = (maps_differ(snap, ref_dgr.maps(reg.pyr))
                              if not row["voxels_differ"] else float("inf"))
        spread = float(reg.logits.max() - reg.logits.min()) if n0 else 0.0
        gap = (float((snap["logits"] - reg.logits).abs().max()) / max(spread, 1e-12)
               if not row["voxels_differ"] else float("inf"))
        row["logit_gap"] = gap if snap.get("same", True) else float("inf")
        # the program's weights in the table's order, for the solve on them
        order = ref_dgr.lex_sort(ref_dgr.correspondences(self._t(q["xyz0"]), self._t(q["xyz1"]),
                                                         nn, self.pcfg.voxel_size))
        w_port = torch.from_numpy(snap["out"]["weights"]).to(self.dev)[order]
        src, dst = self._t(q["xyz0"])[order], self._t(q["xyz1"])[nn[order]]
        T_on_port = ref_dgr.procrustes(src, dst, w_port)
        T = torch.from_numpy(snap["out"]["transformation"]).to(self.dev)
        pts = self._t(q["xyz0"])
        row["pose_gap"] = ref_dgr.pose_gap(T, T_on_port, pts)
        row["pose_gap_ref"] = ref_dgr.pose_gap(T, reg.pose, pts)
        return row

    def control(self, p: int, prec: Precision) -> Dict:
        """The reference at ``prec`` in the program's place: its own
        correspondences, 6-D points, maps, logits and weights, and its pose
        solved on those weights with the points and weights rounded to
        bfloat16 (the step below the program's float32 solve)."""
        q = self.pool[p]
        n0 = len(q["xyz0"])
        f0, f1 = self._t(q["feats0"]), self._t(q["feats1"])
        ok1 = torch.ones(len(f1), dtype=torch.bool, device=self.dev)
        with full_f32():
            nn = ref_dgr_nearest(f0, f1, ok1, prec)
            reg = ref_dgr.register(regcheck.ref_params(self.P), self._t(q["xyz0"]),
                                   self._t(q["xyz1"]), torch.from_numpy(nn).to(self.dev),
                                   self.pcfg.voxel_size, self.clip, prec)
        maps = [m for _, m in ref_dgr.maps(reg.pyr)]
        order = ref_dgr.lex_sort(ref_dgr.correspondences(
            self._t(q["xyz0"]), self._t(q["xyz1"]), torch.from_numpy(nn).to(self.dev),
            self.pcfg.voxel_size))
        w = torch.zeros(n0, device=self.dev)       # the weights in source-row order
        w[order] = reg.weights
        pose = ref_dgr.procrustes(self._t(q["xyz0"])[order],
                                  self._t(q["xyz1"])[torch.from_numpy(nn).to(self.dev).long()[order]],
                                  reg.weights, operands=torch.bfloat16)
        return {"out": {"transformation": pose.float().cpu().numpy(),
                        "weights": w.cpu().numpy()},
                "table": reg.table, "maps": [(m >= 0).nonzero() for m in maps],
                "map_vals": [m[m >= 0] for m in maps], "map_rows": [len(m) for m in maps],
                "logits": reg.logits, "q": f0, "r": f1,
                "q_ok": torch.ones(n0, dtype=torch.bool, device=self.dev), "r_ok": ok1,
                "idx": torch.from_numpy(nn).to(self.dev)}


def ref_dgr_nearest(f0: torch.Tensor, f1: torch.Tensor, ok1: torch.Tensor,
                    prec: Precision = Precision("f32")) -> np.ndarray:
    from reference import registration as ref_reg
    return ref_reg.nearest(f0, f1, ok1, prec).cpu().numpy()


def maps_differ(snap: Dict, ref_maps) -> int:
    """Entries of the program's maps unlike the reference's: live entries
    present in one and not the other or naming another row, and a map
    count that differs."""
    if len(ref_maps) != len(snap["maps"]):
        return abs(len(ref_maps) - len(snap["maps"])) + 1
    out = 0
    for at, vals, (_, ref) in zip(snap["maps"], snap["map_vals"], ref_maps):
        live = (ref >= 0).nonzero()
        if at.shape != live.shape or not torch.equal(at, live):
            got = {(int(r), int(k)): int(v) for (r, k), v in zip(at.tolist(), vals.tolist())}
            want = {(int(r), int(k)): int(ref[r, k]) for r, k in live.tolist()}
            out += sum(1 for key in got.keys() | want.keys() if got.get(key) != want.get(key))
        else:
            out += int((vals.long() != ref[ref >= 0]).sum())
    return out
