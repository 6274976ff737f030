"""Synthetic datasets for tests, demos and the chip smoke run, copied from
video_filler_tpu/data/synthetic.py (that module's package pulls in jax on
import): image folders, masked/gt pair folders, video corpora and logo mask
PNGs, with the on-disk layout of the real ones."""

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


def make_paired_folders(root: str, n: int = 8, h: int = 160, w: int = 200,
                        seed: int = 0) -> tuple[str, str]:
    """(masked_root, gt_root) with a gray box burned into the masked copies."""
    rs = np.random.RandomState(seed)
    d_masked = os.path.join(root, "masked")
    d_gt = os.path.join(root, "gt_pairs")
    os.makedirs(d_masked, exist_ok=True)
    os.makedirs(d_gt, exist_ok=True)
    for i in range(n):
        img = _texture(rs, h, w)
        save_png(os.path.join(d_gt, f"im_{i:04d}.png"), img)
        m = img.copy()
        m[h // 4: h // 2, w // 4: w // 2] = 110
        save_png(os.path.join(d_masked, f"im_{i:04d}.png"), m)
    return d_masked, d_gt


def make_video_corpus(root: str, n_videos: int = 2, frames: int = 12,
                      h: int = 180, w: int = 240, seed: int = 0) -> str:
    """gt/ + gt1/ dirs of numbered frames, layout per datavid/dataset.lua."""
    rs = np.random.RandomState(seed)
    for variant in ("gt", "gt1"):
        d = os.path.join(root, variant)
        os.makedirs(d, exist_ok=True)
        for v in range(n_videos):
            base = _texture(rs, h, w).astype(np.int16)
            for t in range(frames):
                drift = (base + rs.randint(-6, 7, base.shape)).clip(0, 255)
                save_png(os.path.join(d, f"{t + 1:07d}_vid{v}.png"),
                         drift.astype(np.uint8))
    return root


def make_mask_png(path: str, h: int = 180, w: int = 240,
                  box=(20, 30, 60, 90)) -> str:
    """Binary mask PNG: white box = logo region (mask*.png role)."""
    m = np.zeros((h, w, 1), np.uint8)
    y0, x0, y1, x1 = box
    m[y0:y1, x0:x1] = 255
    save_png(path, m)
    return path
