"""Synthetic image folders for tests, demos and the chip smoke run, copied
from video_filler_tpu/data/synthetic.py (that module's package pulls in jax
on import).  Same on-disk layout as a real folder dataset."""

from __future__ import annotations

import os

import numpy as np

from video_filler_tpu.utils.io import save_png


def _texture(rs: np.random.RandomState, h: int, w: int, nc: int = 3
             ) -> np.ndarray:
    """Smooth random texture (low-freq) so crops are rarely 'dark'."""
    small = rs.rand(max(h // 16, 2), max(w // 16, 2), nc)
    ys = np.linspace(0, small.shape[0] - 1, h)
    xs = np.linspace(0, small.shape[1] - 1, w)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    img = small[yi][:, xi]
    img = 0.3 + 0.7 * img  # keep mean above the dark-crop threshold
    return (img * 255).astype(np.uint8)


def make_image_folder(root: str, n: int = 8, h: int = 160, w: int = 200,
                      seed: int = 0) -> str:
    rs = np.random.RandomState(seed)
    d = os.path.join(root, "images")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        save_png(os.path.join(d, f"im_{i:04d}.png"), _texture(rs, h, w))
    return root
