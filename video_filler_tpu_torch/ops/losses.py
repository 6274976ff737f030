"""Loss functions (counterpart of the center-path part of
video_filler_tpu/ops/losses.py).  Every loss is a scalar computed in f32;
the reference's hand-blended gradients (train.lua:376-401) are the autograd
gradients of these objectives."""

from __future__ import annotations

import torch

# sum(weights * (pred-target)**2) / numel in f32 (train.lua:394).  The plain
# form lives beside its kernel; the train step calls the fused kernel.
from video_filler_tpu_torch.ops.cuda.fused_loss import (  # noqa: F401
    weighted_mse_reference as weighted_mse,
)


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy on logits with a scalar label, in f32:
    ``max(x,0) - x*t + log1p(exp(-|x|))``."""
    x = logits.float()
    loss = x.clamp(min=0) - x * target + torch.log1p(torch.exp(-x.abs()))
    return loss.mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nn.MSECriterion: mean squared error over all elements (f32)."""
    return (pred.float() - target.float()).square().mean()


def overlap_l2_weights(shape_hw: tuple[int, int], overlap_pred: int,
                       wtl2: float, overlap_weight: float = 10.0,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """wtl2Matrix (train.lua:391-392): a border ring of width overlapPred
    weighs overlap_weight*wtl2, the interior wtl2.  Returns (H, W, 1) f32."""
    h, w = shape_hw
    if overlap_pred <= 0:
        return torch.full((h, w, 1), wtl2, dtype=torch.float32, device=device)
    mat = torch.full((h, w, 1), overlap_weight * wtl2, dtype=torch.float32,
                     device=device)
    mat[overlap_pred:h - overlap_pred, overlap_pred:w - overlap_pred] = wtl2
    return mat
