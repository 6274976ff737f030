"""Image/GIF output utilities, copied from video_filler_tpu/utils/io.py.

Replaces the reference's `image.save` grids and the ImageMagick `convert`
subprocess for GIF assembly (test_vid.lua:145-147, test_vid_wholeim.lua:247-257)
with in-process PIL writers.
"""

from __future__ import annotations

import math
import os

import numpy as np
from PIL import Image


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """float [-1,1] or uint8 → uint8 [0,255]."""
    if img.dtype == np.uint8:
        return img
    return np.clip((img.astype(np.float32) + 1.0) * 127.5, 0,
                   255).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, C) float [-1,1] or uint8; C in {1, 3}."""
    arr = _to_uint8(np.asarray(img))
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)


def save_image_grid(path: str, images: np.ndarray, n_cols: int | None = None,
                    pad: int = 2) -> None:
    """Tile (N, H, W, C) into a grid PNG (the `disp.image`/grid-save analogue,
    train.lua:442-444, demo.lua:92-97)."""
    images = _to_uint8(np.asarray(images))
    n, h, w, c = images.shape
    n_cols = n_cols or int(math.ceil(math.sqrt(n)))
    n_rows = int(math.ceil(n / n_cols))
    grid = np.full((n_rows * (h + pad) - pad, n_cols * (w + pad) - pad, c),
                   255, np.uint8)
    for i in range(n):
        r, col = divmod(i, n_cols)
        grid[r * (h + pad): r * (h + pad) + h,
             col * (w + pad): col * (w + pad) + w] = images[i]
    save_png(path, grid)


def save_gif(path: str, frames: np.ndarray, fps: int = 8,
             loop: int = 0) -> None:
    """frames: (T, H, W, C) float [-1,1] or uint8 → animated GIF."""
    frames = _to_uint8(np.asarray(frames))
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=loop)
