"""Offline dataset-construction tools (``imfnet_tpu.data.offline``; the
reference's `data/` scripts), on the device unless ``device="cpu"``:
- TSDF fusion of depth frames into fragment clouds
  (`data/fuse_fragments_3DMatch.py:47-96`, Open3D's ScalableTSDFVolume): a
  dense volume on the device; per frame every voxel centre is projected into
  the depth image and the truncated signed distance averaged in; surface
  points are the observed voxels near the zero crossing.
- Pairwise overlap (`data/compute_overlap.py:93-141`, pyflann): the nearest
  neighbour of every point through ``match.nn.nn_auto`` (kernel B on the
  card), then the `<p>-<q>-overlap.txt` pair lists that
  ``IndoorPairDataset`` reads (`lib/data_loaders.py:234`).
- Per-point radius (`data/compute_radius.py:19-53`): half the mean distance
  to the nearest neighbours within a radius.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional, Tuple

import numpy as np
import torch

from imfnet_tpu_torch.match.nn import nn_auto
from imfnet_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# TSDF fusion
# ---------------------------------------------------------------------------


def voxel_centers(origin: torch.Tensor, voxel: float,
                  dims: Tuple[int, int, int]) -> torch.Tensor:
    """f32[X*Y*Z, 3] world positions of a dense grid's voxels, x-major."""
    X, Y, Z = dims
    ii = torch.arange(X * Y * Z, dtype=torch.int32, device=origin.device)
    cells = torch.stack([ii // (Y * Z), (ii // Z) % Y, ii % Z], 1).float()
    return origin + cells * voxel


def tsdf_integrate(tsdf: torch.Tensor, weight: torch.Tensor, depth: torch.Tensor,
                   intrinsic: torch.Tensor, cam_from_world: torch.Tensor,
                   pts: torch.Tensor, trunc: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of TSDF integration over a dense grid whose voxel centres
    are ``pts`` (``voxel_centers``), flattened x-major (weighted running
    average, truncation ``trunc``: Open3D's sdf_trunc contract). ``depth`` is
    f32[H, W] in metres, 0 where invalid; all tensors on one device. Returns
    the new (tsdf, weight). The JAX package's function takes the grid's
    origin, voxel and dims and makes the centres every frame."""
    rot, t = cam_from_world[:3, :3], cam_from_world[:3, 3]
    cam = [pts[:, 0] * rot[a, 0] + pts[:, 1] * rot[a, 1] + pts[:, 2] * rot[a, 2] + t[a]
           for a in range(3)]
    z = cam[2]
    zc = z.clamp_min(1e-6)
    u = cam[0] / zc * intrinsic[0, 0] + intrinsic[0, 2]
    v = cam[1] / zc * intrinsic[1, 1] + intrinsic[1, 2]
    h, w = depth.shape
    # torch.round rounds half to even, as jnp.round
    ui = torch.round(u).to(torch.int64).clamp(0, w - 1)
    vi = torch.round(v).to(torch.int64).clamp(0, h - 1)
    d = depth[vi, ui]
    valid = (z > 1e-4) & (d > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    sdf = d - z
    valid &= sdf > -trunc
    sdf = torch.clamp_max(sdf / trunc, 1.0)
    w_new = weight + valid.float()
    tsdf_new = torch.where(valid, (tsdf * weight + sdf) / w_new.clamp_min(1.0), tsdf)
    return tsdf_new, w_new


def extract_surface(tsdf, weight, origin: np.ndarray, voxel: float,
                    dims: Tuple[int, int, int]) -> np.ndarray:
    """Surface points f64[M, 3]: the centres of observed voxels (weight > 1)
    with |sdf| < 0.5, in x-major order, the point-cloud analogue of
    Open3D's extract_point_cloud. Takes tensors (on any device) or arrays."""
    t = torch.as_tensor(tsdf).reshape(dims)
    w = torch.as_tensor(weight).reshape(dims)
    idx = torch.nonzero((t.abs() < 0.5) & (w > 1)).cpu().numpy()
    return np.asarray(origin, np.float64) + idx.astype(np.float64) * voxel


class TSDFVolume:
    """A dense TSDF volume on ``device`` (the card unless "cpu")."""

    def __init__(self, origin, dims=(256, 256, 256), voxel=3.0 / 512, trunc=0.04,
                 device=None):
        self.device = resolve_device(device)
        self.dims = tuple(dims)
        self.voxel = float(voxel)
        self.trunc = float(trunc)
        self.origin = np.asarray(origin, np.float32)
        n = self.dims[0] * self.dims[1] * self.dims[2]
        self.tsdf = torch.ones(n, device=self.device)
        self.weight = torch.zeros(n, device=self.device)
        self.centers = voxel_centers(torch.from_numpy(self.origin).to(self.device),
                                     self.voxel, self.dims)

    def integrate(self, depth: np.ndarray, intrinsic: np.ndarray,
                  cam_from_world: np.ndarray) -> None:
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

        self.tsdf, self.weight = tsdf_integrate(
            self.tsdf, self.weight, dev(depth), dev(intrinsic), dev(cam_from_world),
            self.centers, self.trunc)

    def extract_point_cloud(self) -> np.ndarray:
        return extract_surface(self.tsdf, self.weight, self.origin.astype(np.float64),
                               self.voxel, self.dims)


def read_depth_png(path: str, depth_scale: float = 1000.0,
                   depth_trunc: float = 6.0) -> np.ndarray:
    """Depth frame in metres from a 16-bit PNG (0 = invalid), the 3DMatch
    frame format read at `data/fuse_fragments_3DMatch.py:36-45`."""
    from PIL import Image

    d = np.asarray(Image.open(path)).astype(np.float32) / depth_scale
    return np.where(d > depth_trunc, 0.0, d)


def fuse_fragment_frames(depth_paths: List[str], pose_paths: List[str],
                         intrinsic: np.ndarray, *,
                         dims: Tuple[int, int, int] = (256, 256, 256),
                         cubic_size: float = 6.0, trunc: Optional[float] = None,
                         depth_scale: float = 1000.0, depth_trunc: float = 6.0,
                         device=None):
    """One fragment's frames fused into a surface cloud and its base pose
    (`process_single_fragment`, `data/fuse_fragments_3DMatch.py:47-96`):
    the poses are rebased to the first frame with a finite pose, the volume
    sits in that base frame, and the returned pose maps the fragment to the
    world. Returns (points f64[N, 3] in the base frame, pose_base2world
    [4, 4]), or (None, None) when no frame has a finite pose."""
    voxel = cubic_size / dims[0]
    if trunc is None:
        # Open3D's sdf_trunc 0.04 at voxel 3/512; at least 2 voxels, so that
        # coarse grids still hold a zero crossing
        trunc = max(0.04, 2.0 * voxel)
    # the volume is centred on the base camera, shifted forward along +z
    origin = np.array([-cubic_size / 2, -cubic_size / 2, -cubic_size / 4], np.float32)
    vol = TSDFVolume(origin, dims=dims, voxel=voxel, trunc=trunc, device=device)
    pose_base2world = None
    base_inv = None
    for dpath, ppath in zip(depth_paths, pose_paths):
        pose = np.loadtxt(ppath).reshape(4, 4)
        if not np.isfinite(pose).all():
            continue
        if base_inv is None:
            pose_base2world = pose
            base_inv = np.linalg.inv(pose)
        cam2base = base_inv @ pose
        depth = read_depth_png(dpath, depth_scale, depth_trunc)
        vol.integrate(depth, intrinsic, np.linalg.inv(cam2base))
    if base_inv is None:
        return None, None
    return vol.extract_point_cloud(), pose_base2world


def fuse_scene(scene_dir: str, out_dir: str, *, frames_per_fragment: int = 50,
               frame_step: int = 1, dims: Tuple[int, int, int] = (256, 256, 256),
               cubic_size: float = 6.0, depth_scale: float = 1000.0,
               depth_trunc: float = 6.0, device=None) -> List[str]:
    """Walks a 3DMatch-style sequence (`frame-XXXXXX.depth.png`,
    `frame-XXXXXX.pose.txt`, `camera-intrinsics.txt`, in ``scene_dir`` or its
    `seq-01`) and writes `cloud_bin_<k>.ply` and `cloud_bin_<k>.pose.npy` per
    fragment of ``frames_per_fragment`` frames (the output of
    `data/fuse_fragments_3DMatch.py:92-96`). Returns the PLY paths."""
    from imfnet_tpu_torch.geom.ply import write_ply

    os.makedirs(out_dir, exist_ok=True)
    K = np.loadtxt(osp.join(scene_dir, "camera-intrinsics.txt")).reshape(3, 3)
    seq = scene_dir
    if osp.isdir(osp.join(scene_dir, "seq-01")):
        seq = osp.join(scene_dir, "seq-01")
    depths = sorted(osp.join(seq, f) for f in os.listdir(seq)
                    if f.endswith(".depth.png"))[::frame_step]
    written = []
    for frag_id in range(len(depths) // frames_per_fragment):
        chunk = depths[frag_id * frames_per_fragment:(frag_id + 1) * frames_per_fragment]
        poses = [d[:-len(".depth.png")] + ".pose.txt" for d in chunk]
        pts, pose = fuse_fragment_frames(
            chunk, poses, K, dims=dims, cubic_size=cubic_size,
            depth_scale=depth_scale, depth_trunc=depth_trunc, device=device)
        if pts is None:
            continue
        ply = osp.join(out_dir, f"cloud_bin_{frag_id}.ply")
        write_ply(ply, pts.astype(np.float32))
        np.save(osp.join(out_dir, f"cloud_bin_{frag_id}.pose.npy"), pose)
        written.append(ply)
    return written


# ---------------------------------------------------------------------------
# Overlap → training pair lists
# ---------------------------------------------------------------------------


def voxel_down_sample_np(pts: np.ndarray, voxel: float) -> np.ndarray:
    """Mean-per-voxel downsample (`o3d.voxel_down_sample`, which caps the
    overlap tool's inputs at `data/compute_overlap.py:101-108`)."""
    keys = np.floor(pts / voxel).astype(np.int64)
    _, inv, cnt = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    out = np.zeros((len(cnt), pts.shape[1]), np.float64)
    np.add.at(out, inv.reshape(-1), pts)
    return (out / cnt[:, None]).astype(pts.dtype)


def compute_overlap_pair(pts_src: np.ndarray, pts_dst: np.ndarray,
                         dist_thresh: float = 0.075, device=None
                         ) -> Tuple[float, np.ndarray]:
    """(overlap ratio, corr int[M, 2] of (src row, dst row)): the nearest
    src point of every dst point, kept within ``dist_thresh``
    (`data/compute_overlap.py:111-127`); the ratio divides the kept count by
    the larger cloud's size. On the card the search is kernel B."""
    dev = resolve_device(device)
    idx, d2 = nn_auto(torch.as_tensor(np.asarray(pts_dst, np.float32)).to(dev),
                      torch.as_tensor(np.asarray(pts_src, np.float32)).to(dev))
    idx = idx.cpu().numpy()
    keep = np.sqrt(d2.cpu().numpy()) <= dist_thresh
    corr = np.stack([idx[keep], np.nonzero(keep)[0]], axis=1)
    ratio = float(keep.sum()) / max(len(pts_src), len(pts_dst))
    return ratio, corr


def build_overlap_lists(fragments: List[Tuple[str, np.ndarray]], out_dir: str,
                        dist_thresh: float = 0.075, min_overlap: float = 0.3,
                        skip_adjacent: bool = True, device=None
                        ) -> List[Tuple[str, str, float]]:
    """Overlap of every pair of (name, points) fragments (adjacent ids
    skipped); for each pair at ``min_overlap`` or more writes
    `<p>-<q>.npy` (correspondences) and `<p>-<q>-overlap.txt` (the files
    ``IndoorPairDataset`` globs, `lib/data_loaders.py:234-241`). Returns
    the kept (p, q, ratio)."""
    os.makedirs(out_dir, exist_ok=True)
    kept = []
    for i, (name_i, pts_i) in enumerate(fragments):
        id_i = int(name_i.split("_")[-1])
        for name_j, pts_j in fragments[i + 1:]:
            if skip_adjacent and id_i + 1 == int(name_j.split("_")[-1]):
                continue
            ratio, corr = compute_overlap_pair(pts_i, pts_j, dist_thresh, device=device)
            if ratio < min_overlap:
                continue
            np.save(osp.join(out_dir, f"{name_i}-{name_j}.npy"), corr)
            with open(osp.join(out_dir, f"{name_i}-{name_j}-overlap.txt"), "w") as f:
                f.write(f"{ratio}")
            kept.append((name_i, name_j, ratio))
    return kept


# ---------------------------------------------------------------------------
# Per-point radius
# ---------------------------------------------------------------------------

RADIUS_CHUNK_ELEMENTS = 1 << 27   # distances of one chunk of queries


def compute_radius(pts: np.ndarray, nn_radius: float = 0.1, k: int = 16,
                   device=None) -> np.ndarray:
    """f32[N]: half the mean distance from each point to those of its ``k``
    nearest other points within ``nn_radius``, 0 where there are none
    (`data/compute_radius.py:19-53`; the k nearest stand in for the
    reference's whole radius set at surface densities). The JAX package
    queries a KD-tree on the host; here exact f64 distances of a chunk of
    queries to every point, and the k + 1 smallest (the point itself is
    among them and dropped by index), on the device."""
    dev = resolve_device(device)
    n = len(pts)
    x = torch.as_tensor(np.asarray(pts, np.float64)).to(dev)
    kk = min(k + 1, n)
    rows = max(1, RADIUS_CHUNK_ELEMENTS // max(n, 1))
    out = []
    for s in range(0, n, rows):
        q = x[s:s + rows]
        dist = torch.cdist(q, x, compute_mode="donot_use_mm_for_euclid_dist")
        dd, ii = torch.topk(dist, kk, dim=1, largest=False)
        own = torch.arange(s, s + q.shape[0], device=dev)[:, None]
        use = (ii != own) & (dd <= nn_radius)
        cnt = use.sum(dim=1)
        mean = (dd * use).sum(dim=1) / cnt.clamp_min(1)
        out.append(torch.where(cnt > 0, mean * 0.5, torch.zeros_like(mean)))
    if not out:
        return np.zeros(0, np.float32)
    return torch.cat(out).cpu().numpy().astype(np.float32)
