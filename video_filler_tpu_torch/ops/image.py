"""On-device image preprocessing (counterpart of video_filler_tpu/ops/image.py).

The host pipeline decodes and crops; normalisation, the per-sample crop and
the horizontal flip run on the device, on (B,H,W,C) tensors (a folded clip
keeps its frame-major channels on the last axis).  Random
decisions are drawn by the caller from a ``torch.Generator`` and passed in,
so a test can hand over the JAX side's decisions.
"""

from __future__ import annotations

import torch


def normalize_uint8(x: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> float [-1,1] (donkey ``mul(2):add(-1)``)."""
    return x.to(dtype) * (2.0 / 255.0) - 1.0


def denormalize_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float [-1,1] -> uint8 [0,255] for PNG output."""
    y = ((x + 1.0) * (255.0 / 2.0)).clamp(0.0, 255.0)
    return torch.round(y).to(torch.uint8)


def draw_crop_offsets(gen: torch.Generator, batch: int, h: int, w: int,
                      crop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample offsets uniform over 0..H-crop-1 (the Lua range, as in the
    JAX ``random_crop``).  int64 tensors of shape (B,) on the CPU."""
    y0 = torch.randint(0, max(h - crop, 1), (batch,), generator=gen)
    x0 = torch.randint(0, max(w - crop, 1), (batch,), generator=gen)
    return y0, x0


def random_crop(images: torch.Tensor, crop: int, y0: torch.Tensor,
                x0: torch.Tensor) -> torch.Tensor:
    """Per-sample (crop, crop) window at offsets (y0[b], x0[b])
    (donkey_folder.lua:77-81).  images: (B,H,W,C)."""
    b = images.shape[0]
    ar = torch.arange(crop, device=images.device)
    rows = (y0.to(images.device)[:, None] + ar)[:, :, None]   # (B,crop,1)
    cols = (x0.to(images.device)[:, None] + ar)[:, None, :]   # (B,1,crop)
    idx = torch.arange(b, device=images.device)[:, None, None]
    return images[idx, rows, cols]


def draw_flips(gen: torch.Generator, batch: int,
               prob: float = 0.5) -> torch.Tensor:
    """Per-sample flip decisions: bool (B,) on the CPU."""
    return torch.rand(batch, generator=gen) < prob


def random_hflip(images: torch.Tensor, flip: torch.Tensor,
                 *companions: torch.Tensor):
    """Flip the samples where ``flip`` is set along W (axis 2, NHWC), and
    each companion tensor with the same decisions (gt, masked and mask flip
    together, datavid/donkey_folder.lua:174-180).  Returns one tensor, or a
    tuple when companions are given."""
    flip = flip.to(images.device)

    def apply(x):
        sel = flip.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(sel, x.flip(2), x)

    out = tuple(apply(x) for x in (images, *companions))
    return out if companions else out[0]
