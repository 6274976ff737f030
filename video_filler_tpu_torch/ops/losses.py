"""Loss functions and image-quality metrics (counterpart of
video_filler_tpu/ops/losses.py).  Every loss is a scalar computed in f32;
the reference's hand-blended gradients (train.lua:376-401,
train_vid_weighted.lua:493-498) are the autograd gradients of these
objectives.  ``psnr`` and ``ssim`` score eval outputs (eval/metrics.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """PSNR in dB (f32); range 2.0 for [-1,1] images.  The error is clamped
    at 1e-12, so equal images give a finite value."""
    err = (pred.float() - target.float()).square().mean()
    return 10.0 * torch.log10(data_range ** 2 / err.clamp(min=1e-12))


def _gaussian_kernel(size: int, sigma: float,
                     device: torch.device) -> torch.Tensor:
    r = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-0.5 * (r / sigma).square())
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 2.0,
         size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM (Wang et al. 2004) of (B,H,W,C) images in f32: an 11x11
    Gaussian window (sigma 1.5) applied per channel as a VALID depthwise
    conv, the K1=0.01 / K2=0.03 constants, range 2.0 for [-1,1] images."""
    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().permute(0, 3, 1, 2)
    c = x.shape[1]
    win = _gaussian_kernel(size, sigma, x.device).expand(c, 1, size, size)

    def blur(t):
        return F.conv2d(t, win, groups=c)

    mu_x, mu_y = blur(x), blur(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x2 = blur(x * x) - mu_x2
    sig_y2 = blur(y * y) - mu_y2
    sig_xy = blur(x * y) - mu_xy
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x2 + sig_y2 + c2)
    return (num / den).mean()
