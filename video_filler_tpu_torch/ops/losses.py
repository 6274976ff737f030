"""Loss functions (counterpart of the training losses of
video_filler_tpu/ops/losses.py).  Every loss is a scalar computed in f32;
the reference's hand-blended gradients (train.lua:376-401,
train_vid_weighted.lua:493-498) are the autograd gradients of these
objectives."""

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


def mask_l2_weights(mask: torch.Tensor,
                    weight_nomask: float) -> torch.Tensor:
    """weights = mask*(1-λ) + λ (train_vid_weighted.lua:494-495): masked
    (logo) pixels weigh 1, context pixels λ.  Keeps mask's shape."""
    return mask * (1.0 - weight_nomask) + weight_nomask


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               m_weight: float = 1.0) -> torch.Tensor:
    """nn.MaskedMSECriterion(mWeight): mean(((1-w)M + w) * (pred-target)^2)
    (MaskedMSECriterion.lua:11-19)."""
    w = (1.0 - m_weight) * mask + m_weight
    return (w * (pred - target).square()).mean()


def gdl(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Axis-consistent gradient-difference loss (alpha = 1) in f32:
    mean(| |dY| - |dŶ| |) over H (axis -3) plus the same over W (axis -2).
    The reference's nn.GDLCriterion pairs a column crop with a row crop
    (gdl_criterion.lua:12-23); this is the form it intends, as in the JAX
    package."""
    p32, t32 = pred.float(), target.float()

    def term(dim):
        gy = torch.diff(t32, dim=dim).abs()
        gp = torch.diff(p32, dim=dim).abs()
        return (gy - gp).abs().mean()

    return term(-3) + term(-2)


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
