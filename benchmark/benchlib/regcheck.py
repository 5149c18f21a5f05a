"""The comparison that decides ``correct`` in the registration cells.

For one registered pair the program hands over what its timed path
produced: its voxel table and descriptors (read from the graph's own
output buffers, see the drivers) and its result (pose and metrics). The
reference works out the voxels and descriptors again from the raw inputs
and the weights (``descriptors``), and the registration from the
program's descriptors with the same draws (``judge``), since nearest
neighbours of descriptors that differ by rounding may swap near ties and
RANSAC would then follow another path. Numbers, each widest over the pairs
checked:

- ``voxels_differ``: voxels of the program's table that differ from the
  reference's, row for row, plus the difference in count (exact: 0);
- ``desc_gap``: the largest L2 distance between a voxel's descriptor and
  the reference's (both unit vectors);
- ``fitness_gap``: in correspondences, how many fewer inliers the
  program's pose has on the reference's correspondences than the pose the
  reference's RANSAC finds with the same draws, or how far the program's
  reported fitness is from its pose's count there, whichever is more;
- ``mutual_gap``: the difference in mutual-nearest inliers;
- ``nn_wrong``: valid keypoints whose index from the program's match layer
  is not a nearest valid neighbour over the program's own descriptors:
  the squared distance to the one it chose exceeds the nearest's by more
  than ``NN_TIE`` (exact: 0).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from reference import model as ref_model
from reference import registration as ref_reg
from reference import voxels as ref_vox
from reference.precision import Precision, full_f32


# squared L2 by which a chosen neighbour may lie beyond the nearest: unit
# descriptors' f32 distances in kernel B and in the recount differ by
# 1e-5 at most, so a choice within it is a tie
NN_TIE = 1e-4


class Side(NamedTuple):
    xyz: torch.Tensor        # f32[n_rows, 3] the table's representative points
    feats: torch.Tensor      # f32[n_rows, D] descriptors (padding rows zero)
    eligible: torch.Tensor   # bool[n_rows] rows of this fragment
    u: torch.Tensor          # f32[n_rows] keypoint keys


def voxels_differ(port: torch.Tensor, ref: torch.Tensor) -> int:
    n = min(len(port), len(ref))
    return int((port[:n].long() != ref[:n].long()).any(dim=1).sum()) + abs(len(port) - len(ref))


def descriptors(P, m: Dict, coords: torch.Tensor, images: torch.Tensor,
                prec: Precision) -> torch.Tensor:
    """The reference's descriptors of a sorted voxel table."""
    pyr = ref_vox.pyramid(coords, num_levels=4, conv1_kernel_size=m["conv1_kernel_size"])
    return ref_model.descriptors(P, pyr, images, m, prec)


def desc_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    return float((port.float() - ref.float()).norm(dim=1).max()) if len(ref) else 0.0


def nn_wrong(q: torch.Tensor, r: torch.Tensor, q_valid: torch.Tensor,
             r_valid: torch.Tensor, idx: torch.Tensor) -> int:
    """How many valid queries the index ``idx`` does not give a nearest
    valid reference: a reference that is not valid, or one farther than
    the nearest by more than ``NN_TIE``."""
    q, r = q.float()[q_valid], r.float()
    idx = idx.long()[q_valid]
    if not len(q) or not bool(r_valid.any()):
        return 0
    best = ref_reg.nearest(q, r, r_valid, Precision("f32"))
    inside = (idx >= 0) & (idx < len(r))
    got = idx.clamp(0, len(r) - 1)
    d_got = ((q - r[got]) ** 2).sum(1)
    d_best = ((q - r[best]) ** 2).sum(1)
    wrong = ~inside | ~r_valid[got] | (d_got > d_best + NN_TIE)
    return int(wrong.sum())


def pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + t.shape[1:], dtype=t.dtype, device=t.device)
    out[:len(t)] = t
    return out


def register(sides: List[Side], k: int, samples: torch.Tensor, ransac_thresh: float,
             prec: Precision):
    """Keypoints, both NN directions and RANSAC on the sides' descriptors:
    (kp0, kp1, ok0, ok1, nn01, nn10, T01)."""
    (i0, ok0), (i1, ok1) = (ref_reg.sample_rows(s.eligible, s.u, k) for s in sides)
    kp0, kp1 = sides[0].xyz[i0], sides[1].xyz[i1]
    kd0, kd1 = sides[0].feats[i0], sides[1].feats[i1]
    nn01, nn10 = ref_reg.keypoint_pairs(kd0, kd1, ok0, ok1, prec)
    T01 = ref_reg.ransac(kp0, kp1[nn01], ok0, ransac_thresh, samples)
    return kp0, kp1, ok0, ok1, nn01, nn10, T01


def judge(sides: List[Side], out: Dict[str, torch.Tensor], k: int, samples: torch.Tensor,
          T_gt: torch.Tensor, ransac_thresh: float, inlier_thresh: float) -> Dict[str, float]:
    """The registration numbers of one pair whose program result is
    ``out``; ``sides`` carry the program's descriptors."""
    with full_f32():
        kp0, kp1, ok0, ok1, nn01, nn10, T_ref = register(sides, k, samples, ransac_thresh,
                                                         Precision("f32"))
        es_T = out["transformation"].float()
        T_port = torch.linalg.inv_ex(es_T.double())[0].float()
        dst = kp1[nn01]
        n_ref = int(ref_reg.inliers(T_ref, kp0, dst, ok0, ransac_thresh).sum())
        n_port = int(ref_reg.inliers(T_port, kp0, dst, ok0, ransac_thresh).sum())
        reported = float(out["fitness"]) * int(ok0.sum())
        mutual = ref_reg.mutual_inliers(kp0, kp1, nn01, nn10, ok1, T_gt, inlier_thresh)
    return {"fitness_gap": max(n_ref - n_port, abs(reported - n_port)),
            "mutual_gap": abs(mutual - float(out["num_inliers"]))}


def control_result(sides: List[Side], k: int, samples: torch.Tensor, T_gt,
                   ransac_thresh: float, inlier_thresh: float,
                   prec: Precision) -> Dict[str, torch.Tensor]:
    """The result the reference gives in the program's place at
    ``prec``: its own NN and RANSAC."""
    with full_f32():
        kp0, kp1, ok0, ok1, nn01, nn10, T01 = register(sides, k, samples, ransac_thresh, prec)
        n = int(ref_reg.inliers(T01, kp0, kp1[nn01], ok0, ransac_thresh).sum())
        mutual = ref_reg.mutual_inliers(kp0, kp1, nn01, nn10, ok1, T_gt, inlier_thresh)
    return {"transformation": torch.linalg.inv_ex(T01.double())[0].float(),
            "fitness": torch.tensor(n / max(int(ok0.sum()), 1)),
            "num_inliers": torch.tensor(float(mutual))}


def worst(rows: List[Dict[str, float]], limits: Dict[str, float]):
    """[(name, widest value, limit)] over the pairs checked, in the order of
    ``limits``."""
    return [(name, max(float(r[name]) for r in rows) if rows else float("inf"), lim)
            for name, lim in limits.items()]


def ref_params(P: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights as the reference reads them: float32 copies."""
    return {k: (v.float() if v.is_floating_point() else v) for k, v in P.items()}
