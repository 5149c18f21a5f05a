"""3DMatch benchmark fixture I/O: gt.log poses and gt.info covariances
(``imfnet_tpu.geom.trajectory``).

Replaces `util/trajectory.py:17-39` (read/write_trajectory) and
`util/uio.py:202-233` (read_log / read_info_file). File formats:

gt.log: blocks of 5 lines — "id0 id1 num_fragments" then a 4x4 pose.
gt.info: blocks of 7 lines — "id0 id1 num_fragments" then a 6x6 covariance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class CameraPose:
    metadata: List[int]
    pose: np.ndarray

    # aliases used by the benchmark pipeline (evaluation_3dmatch.py reads
    # gt.log entries as (indices, transformation))
    @property
    def indices(self) -> List[int]:
        return self.metadata

    @property
    def transformation(self) -> np.ndarray:
        return self.pose

    def __str__(self):
        return (
            "metadata : " + " ".join(map(str, self.metadata)) + "\n"
            + "pose : \n" + np.array_str(self.pose)
        )


def read_trajectory(filename: str, dim: int = 4) -> List[CameraPose]:
    traj = []
    with open(filename) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        metadata = list(map(int, lines[i].split()))
        mat = np.zeros((dim, dim))
        for j in range(dim):
            mat[j] = np.fromstring(lines[i + j + 1], dtype=float, sep=" \t")
        traj.append(CameraPose(metadata, mat))
        i += dim + 1
    return traj


def write_trajectory(traj: List[CameraPose], filename: str, dim: int = 4) -> None:
    with open(filename, "w") as f:
        for t in traj:
            f.write(" ".join(map(str, t.metadata)) + "\n")
            for j in range(dim):
                f.write(
                    "\t".join(map("{0:.12f}".format, t.pose[j])) + "\n"
                )


def read_log(filepath: str) -> List[CameraPose]:
    """`util/uio.py:202-215` contract: list of poses with .metadata=[i,j,n]."""
    return read_trajectory(filepath, dim=4)


def read_info_file(filename: str) -> List[Dict]:
    """`util/uio.py:217-233`: per-pair 6x6 covariances for the RR test."""
    with open(filename) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    out = []
    i = 0
    while i < len(lines):
        head = lines[i].split()
        pair = [int(head[0]), int(head[1])]
        num_fragments = int(head[2])
        info = np.array(
            [lines[i + j + 1].split() for j in range(6)], dtype=np.float32
        )
        out.append(dict(test_pair=pair, num_fragments=num_fragments, covariance=info))
        i += 7
    return out
