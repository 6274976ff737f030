"""Center-hole synthesis and compositing (counterpart of the center part of
video_filler_tpu/ops/masks.py).  Layout (B,H,W,C)."""

from __future__ import annotations

import torch

# train.lua:288-290 -- ImageNet per-channel means, normalized to [-1,1].
CENTER_FILL_RGB = tuple(2.0 * m / 255.0 - 1.0 for m in (117.0, 104.0, 123.0))


def center_region(fine_size: int) -> tuple[int, int]:
    """[start, stop) rows/cols of the fineSize/2 center (train.lua:287)."""
    return fine_size // 4, fine_size // 4 + fine_size // 2


def extract_center(images: torch.Tensor) -> torch.Tensor:
    """The central fineSize/2 square, as a strided view (train.lua:287)."""
    lo, hi = center_region(images.shape[1])
    return images[:, lo:hi, lo:hi, :]


def center_mask_fill(images: torch.Tensor, overlap_pred: int = 0,
                     fill=CENTER_FILL_RGB) -> torch.Tensor:
    """A copy of ``images`` with the center hole, minus an overlapPred-wide
    context ring, set to the per-channel means (train.lua:288-290).  C may be
    nc*predLen: the fill repeats per frame."""
    lo, hi = center_region(images.shape[1])
    lo, hi = lo + overlap_pred, hi - overlap_pred
    c = images.shape[-1]
    fill_vec = torch.tensor([fill[i % len(fill)] for i in range(c)],
                            dtype=images.dtype, device=images.device)
    out = images.clone()
    out[:, lo:hi, lo:hi, :] = fill_vec
    return out


def paste_center(ctx: torch.Tensor, pred_center: torch.Tensor,
                 overlap_pred: int = 0) -> torch.Tensor:
    """Paste the predicted center back into the context image, keeping the
    overlapPred ring from the context (train.lua:441, demo.lua:73-76)."""
    lo, hi = center_region(ctx.shape[1])
    lo, hi = lo + overlap_pred, hi - overlap_pred
    op = overlap_pred
    inner = pred_center[:, op:pred_center.shape[1] - op,
                        op:pred_center.shape[2] - op, :]
    out = ctx.clone()
    out[:, lo:hi, lo:hi, :] = inner.to(ctx.dtype)
    return out
