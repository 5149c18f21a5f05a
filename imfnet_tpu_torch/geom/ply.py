"""Minimal PLY point-cloud reader and writer (pure numpy; ``imfnet_tpu.geom.ply``).

Replaces `o3d.io.read_point_cloud` for the fragment files used by the
reference (`lib/data_loaders.py:256`, `dam.py:53`): ascii and
binary_little_endian PLYs with x/y/z plus optional normals and colors.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Returns dict with 'points' [N,3] float64 and, when present,
    'normals' [N,3], 'colors' [N,3] in [0,1]."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                cur = (tok[1].decode(), int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    cur[2].append((tok[4].decode(), "list", tok[2].decode(), tok[3].decode()))
                else:
                    cur[2].append((tok[2].decode(), _PLY_DTYPES[tok[1].decode()]))
            elif tok[0] == b"end_header":
                break

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(len(p) > 2 for p in props):  # list property (faces) — skip payload
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    for _ in range(count):
                        (n,) = np.frombuffer(
                            f.read(np.dtype(_PLY_DTYPES[props[0][2]]).itemsize),
                            dtype=_PLY_DTYPES[props[0][2]],
                        )
                        f.read(int(n) * np.dtype(_PLY_DTYPES[props[0][3]]).itemsize)
                continue
            if fmt == "ascii":
                rows = np.loadtxt(f, max_rows=count, dtype=np.float64)
                rows = np.atleast_2d(rows)
                rec = {p[0]: rows[:, i] for i, p in enumerate(props)}
            else:
                if fmt != "binary_little_endian":
                    raise ValueError(f"{path}: unsupported format {fmt}")
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                buf = f.read(dt.itemsize * count)
                arr = np.frombuffer(buf, dtype=dt, count=count)
                rec = {p[0]: arr[p[0]] for p in props}
            if name != "vertex":
                continue
            out["points"] = np.stack(
                [rec["x"], rec["y"], rec["z"]], axis=1
            ).astype(np.float64)
            if all(k in rec for k in ("nx", "ny", "nz")):
                out["normals"] = np.stack(
                    [rec["nx"], rec["ny"], rec["nz"]], axis=1
                ).astype(np.float64)
            if all(k in rec for k in ("red", "green", "blue")):
                cols = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
                if cols.dtype != np.float64 or cols.max() > 1.0:
                    cols = cols.astype(np.float64) / 255.0
                out["colors"] = cols
        if "points" not in out:
            raise ValueError(f"{path}: no vertex element found")
        return out


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """Binary little-endian writer: x/y/z as float, optional normals, colours
    in [0, 1] (or uint8) as uchar red/green/blue."""
    n = len(points)
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        props += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    arr = np.zeros(n, dtype=np.dtype(props))
    arr["x"], arr["y"], arr["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        arr["nx"], arr["ny"], arr["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        c = colors
        if c.dtype != np.uint8:
            c = np.clip(c * 255.0, 0, 255).astype(np.uint8)
        arr["red"], arr["green"], arr["blue"] = c[:, 0], c[:, 1], c[:, 2]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        type_names = {"<f4": "float", "u1": "uchar"}
        for name, dt in props:
            f.write(f"property {type_names[dt]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(arr.tobytes())
