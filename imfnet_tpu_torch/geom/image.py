"""Image loading + resize for the fusion branch.

Replaces cv2-based `process_image` (`util/uio.py:18-99`, "resize" mode is the
only one used by the pipeline: `lib/data_loaders.py:260-266`) with a
PIL/numpy loader + bilinear resize (``imfnet_tpu.geom.image``), and the
point-to-pixel projection and crop helpers of the dataset construction. PIL
is imported inside the two functions that read and write files, so nothing
else needs it.
"""
from __future__ import annotations

import numpy as np


def _bilinear_resize_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.INTER_LINEAR-compatible bilinear resize (half-pixel centers)."""
    h, w = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    im = img if img.ndim == 3 else img[..., None]
    out = (
        im[y0][:, x0] * (1 - wy) * (1 - wx)
        + im[y0][:, x1] * (1 - wy) * wx
        + im[y1][:, x0] * wy * (1 - wx)
        + im[y1][:, x1] * wy * wx
    )
    return out if img.ndim == 3 else out[..., 0]


def process_image(image: np.ndarray, aim_H: int = 120, aim_W: int = 160) -> np.ndarray:
    """Resize to the model's image shape; float32 HWC (reference contract at
    `util/uio.py:18-41`)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=2)
    if image.shape[2] > 3:
        image = image[..., :3]
    if image.shape[0] == aim_H and image.shape[1] == aim_W:
        return image
    return _bilinear_resize_np(image, aim_H, aim_W).astype(np.float32)


def load_image(path: str) -> np.ndarray:
    """Read an image file to float32 [0,1] HWC (matplotlib.image.imread
    semantics for PNG used at `lib/data_loaders.py:259`)."""
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


def save_image(path: str, image: np.ndarray) -> None:
    """Write an HWC image (uint8, or float in [0,1]) to disk."""
    from PIL import Image

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    Image.fromarray(img).save(path)


# ---------------------------------------------------------------------------
# Point → image projection (3DImageMatch dataset construction)
# ---------------------------------------------------------------------------

def project_points(
    points_cam: np.ndarray,   # [N,3] points in the CAMERA frame
    intrinsic: np.ndarray,    # [3,3] pinhole K
) -> np.ndarray:
    """Pinhole projection u = |x·fx/z + cx|, v = |y·fy/z + cy| — the
    `carema2pixe` contract (`util/uio.py:483-506`, including its abs() fold of
    behind-camera points). Returns float [N,2] (u, v)."""
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    z = points_cam[:, 2]
    z = np.where(np.abs(z) < 1e-12, 1e-12, z)
    u = np.abs(points_cam[:, 0] * fx / z + cx)
    v = np.abs(points_cam[:, 1] * fy / z + cy)
    return np.stack([u, v], axis=1)


def point_to_pixel(
    point_cam: np.ndarray,    # [3] one point (camera frame)
    points_all: np.ndarray,   # [N,3] fragment points (camera frame)
    intrinsic: np.ndarray,
    width: int,
    height: int,
):
    """Pixel of one point with the reference's max-pixel normalization: raw
    projections are rescaled so the fragment's max (u, v) maps to the image
    extent (`util/uio.py:483-506` + `max_pixel`). Returns int (u, v)."""
    uv_all = project_points(points_all, intrinsic)
    u_max = max(float(uv_all[:, 0].max()), 1e-12)
    v_max = max(float(uv_all[:, 1].max()), 1e-12)
    uv = project_points(point_cam[None], intrinsic)[0]
    u = int(np.floor(uv[0] * width / u_max))
    v = int(np.floor(uv[1] * height / v_max))
    return u, v


def crop_around_pixel(image: np.ndarray, u: int, v: int, size: int) -> np.ndarray:
    """Square ``size``×``size`` crop centered at pixel (u, v) with wrap-around
    at the borders — the behavior of `p2i` (`util/uio.py:300-460`), whose
    8-way border case analysis is equivalent to a toroidal index. Images
    smaller than ``size`` tile periodically (the reference's "full up image"
    path). Returns [size, size, C]."""
    h, w = image.shape[:2]
    half = size // 2
    rows = np.arange(v - half, v - half + size) % h
    cols = np.arange(u - half, u - half + size) % w
    return image[rows][:, cols]


def fragment_image_crop(
    points_world: np.ndarray,   # [N,3] fragment points (world frame)
    camera_pose: np.ndarray,    # [4,4] camera-to-world
    intrinsic: np.ndarray,
    image: np.ndarray,          # [H,W,C] the camera's frame
    size: int,
) -> np.ndarray:
    """Crop of ``image`` centered on the fragment centroid's projection —
    the dataset-construction step pairing each fragment with an image patch
    (`util/uio.py:262-298` image slicing + `p2i`)."""
    world_to_cam = np.linalg.inv(camera_pose)
    pts_cam = points_world @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
    centroid = pts_cam.mean(axis=0)
    u, v = point_to_pixel(centroid, pts_cam, intrinsic,
                          image.shape[1], image.shape[0])
    return crop_around_pixel(image, u, v, size)
