"""Image loading + resize for the fusion branch.

Replaces cv2-based `process_image` (`util/uio.py:18-99`, "resize" mode is the
only one used by the pipeline: `lib/data_loaders.py:260-266`) with a
PIL/numpy loader + bilinear resize (``imfnet_tpu.geom.image``). PIL is
imported inside the two functions that read and write files, so nothing else
needs it.
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
