"""Mask synthesis and compositing (counterpart of
video_filler_tpu/ops/masks.py).  Layout (B,H,W,C).

* the center hole with its per-channel mean fill and overlapPred ring
  (train.lua:287-290);
* logo masks binarized from a PNG (datavid/donkey_folder.lua:33-35) and the
  random-block fallback for an empty mask crop
  (datavid/donkey_folder.lua:114-129,165-169);
* masked_fill / fill_in compositing (inpaint_utils.lua:30-101) as
  fixed-shape ``torch.where``.

Random decisions are drawn by the caller (``random_block_draws``) and passed
in, so a test can hand over the JAX side's draws.  A (B,H,W,1) mask
broadcasts over the nc*predLen channels of a folded clip.
"""

from __future__ import annotations

import numpy as np
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


def binarize_mask(mask01: np.ndarray, mode: str = "byte") -> np.ndarray:
    """Binarize a [0,1] float mask image (host side, numpy).

    mode='byte':  Torch ``image.load(...):byte()`` truncates toward zero, so
                  only exactly-1.0 (uint8 255) pixels survive
                  (datavid/donkey_folder.lua:33-35).
    mode='gt03':  the ``:gt(0.3)`` threshold of the tiled eval
                  (test_vid_wholeim.lua:111,121).
    """
    if mode == "byte":
        return (mask01 >= 1.0).astype(np.uint8)
    if mode == "gt03":
        return (mask01 > 0.3).astype(np.uint8)
    raise ValueError(f"unknown binarize mode {mode!r}")


def masked_fill(images: torch.Tensor, mask: torch.Tensor,
                value: float) -> torch.Tensor:
    """maskedFill: masked pixels set to ``value`` in images' dtype
    (inpaint_utils.lua:30-60).  mask (bool or {0,1}) broadcasts against
    images."""
    return torch.where(mask.bool(),
                       torch.tensor(value, dtype=images.dtype,
                                    device=images.device), images)


def fill_in(dst: torch.Tensor, mask: torch.Tensor,
            src: torch.Tensor) -> torch.Tensor:
    """fillIn: src's masked pixels copied into dst (inpaint_utils.lua:63-101).
    The result takes the promoted dtype of src and dst, as ``jnp.where``
    does: a bf16 fake filled into an f32 target is f32."""
    return torch.where(mask.bool(), src, dst)


def random_block_draws(gen: torch.Generator, batch: int, height: int,
                       width: int, max_blocks: int = 10,
                       min_blocks: int = 2) -> dict[str, torch.Tensor]:
    """The random-block mask's decisions, drawn on the CPU from ``gen``:
    ``n_blocks`` (B,) in [min_blocks, max_blocks] and top-left corners
    ``tly``/``tlx`` (B, max_blocks) in [2, dim - bs - 3], the exclusive upper
    bound ``dim - bs - 2`` of the JAX draw (masks.py:108-110)."""
    bs = height // 6
    return {
        "n_blocks": torch.randint(min_blocks, max_blocks + 1, (batch,),
                                  generator=gen),
        "tly": torch.randint(2, height - bs - 2, (batch, max_blocks),
                             generator=gen),
        "tlx": torch.randint(2, width - bs - 2, (batch, max_blocks),
                             generator=gen),
    }


def random_block_mask(n_blocks: torch.Tensor, tly: torch.Tensor,
                      tlx: torch.Tensor, height: int, width: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Random square-block masks (datavid/donkey_folder.lua:114-129): per
    sample the first ``n_blocks[b]`` of the (B, max_blocks) blocks of side
    floor(H/6) at (tly, tlx).  Returns (B, H, W, 1) f32 {0,1}."""
    bs = height // 6
    n_blocks, tly, tlx = (t.to(device) for t in (n_blocks, tly, tlx))
    max_blocks = tly.shape[1]
    rows = torch.arange(height, device=device)[None, None, :, None]
    cols = torch.arange(width, device=device)[None, None, None, :]
    ty, tx = tly[:, :, None, None], tlx[:, :, None, None]
    in_y = (rows >= ty) & (rows < ty + bs)
    in_x = (cols >= tx) & (cols < tx + bs)
    valid = (torch.arange(max_blocks, device=device)[None, :]
             < n_blocks[:, None])[:, :, None, None]
    blocks = in_y & in_x & valid                    # (B, max_blocks, H, W)
    return blocks.any(dim=1)[..., None].float()


def mask_or_random_block(cropped_mask: torch.Tensor,
                         draws: dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-sample fallback: a sample whose cropped logo mask is empty gets a
    random block mask instead (datavid/donkey_folder.lua:165-169).
    cropped_mask: (B, H, W, 1) in {0,1}; ``draws`` from random_block_draws."""
    _, h, w, _ = cropped_mask.shape
    rand = random_block_mask(draws["n_blocks"], draws["tly"], draws["tlx"],
                             h, w, cropped_mask.device)
    has_mask = cropped_mask.amax(dim=(1, 2, 3), keepdim=True) > 0.5
    return torch.where(has_mask, cropped_mask, rand)


def apply_logo_mask(images: torch.Tensor, mask: torch.Tensor,
                    mask_value: float) -> torch.Tensor:
    """masked = maskedFill(gt, mask, maskValue) then [0,1] -> [-1,1]
    (datavid/donkey_folder.lua:161-186): on normalized images the fill value
    is 2*maskValue-1."""
    return masked_fill(images, mask, 2.0 * mask_value - 1.0)
