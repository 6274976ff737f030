"""Adam with bfloat16 moment storage, ``adamMomentsBf16`` (counterpart of
the JAX package's ``_adam_lowmem``, video_filler_tpu/train/step.py:60-96).

Halving the moments' bytes halves the optimizer state's memory traffic;
the price is ~2^-8 relative rounding of the moments, which perturbs a
trajectory, so the option is opt-in and f32 ``torch.optim.Adam`` the
default.  Plain tensor ops: this is not a kernel of the TPU package.
"""

from __future__ import annotations

import torch


class AdamBf16Moments(torch.optim.Optimizer):
    """Adam with its moments stored in bfloat16 and its math in f32
    (``adamMomentsBf16``; the JAX package's ``_adam_lowmem``,
    video_filler_tpu/train/step.py:60-96).  Per step, with g the f32
    gradient and the count an int32:

        mu = bf16(b1*mu + (1-b1)*g)     nu = bf16(b2*nu + (1-b2)*g**2)
        p += -lr * (mu/bc1) / (sqrt(nu/bc2) + eps),  bc = 1 - b**count

    the update from the rounded moments, the bias corrections in f32.
    State per parameter: ``step`` (int32), ``exp_avg`` and ``exp_avg_sq``
    (bf16), the names ``torch.optim.Adam`` uses, so checkpoint/ckpt.py
    reads both alike."""

    def __init__(self, params, lr: float, betas=(0.5, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.int32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p,
                                                        dtype=torch.bfloat16)
                st["step"] += 1
                g = p.grad.float()
                mu = (b1 * st["exp_avg"].float() + (1 - b1) * g).bfloat16()
                nu = (b2 * st["exp_avg_sq"].float()
                      + (1 - b2) * g.square()).bfloat16()
                st["exp_avg"], st["exp_avg_sq"] = mu, nu
                c = st["step"].float()
                bc1 = 1 - torch.pow(b1, c)
                bc2 = 1 - torch.pow(b2, c)
                p.add_(-lr * (mu.float() / bc1)
                       / ((nu.float() / bc2).sqrt() + eps))
        return None
