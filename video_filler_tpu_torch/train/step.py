"""The center-regime GAN train step (counterpart of
video_filler_tpu/train/step.py).

One step: a G forward, D on the real center and on the detached fake (BN
running statistics updated in that order), D on the fake again for G's
adversarial term, then both gradients at the current weights and two Adam
updates -- the simultaneous form of the reference's fDx/fGx closures
(train.lua:278-409, train.lua:421-424).

The step runs eagerly and updates the ``TrainState`` in place: the networks'
weights and BN buffers and the optimizers' moments.

* G's reconstruction term is the ring-weighted MSE (train.lua:389-400),
  computed by the fused CUDA kernel (ops/cuda/fused_loss.py) on every step;
  ``usePallasLoss`` has no effect here.  ``errG_l2`` is logged unweighted.
* D's parameters get only ``loss_d`` (the fake is detached); G's get only
  ``loss_g``, through the third D pass whose running statistics are not
  updated.  ``backward(inputs=...)`` keeps each loss off the other net.
* Adam: ``torch.optim.Adam(betas=(beta1, 0.999), eps=1e-8)``, which adds eps
  after bias correction, as optax does.  G's learning rate is 10x D's when
  0 < wtl2 < 1 (train.lua:218-222).
"""

from __future__ import annotations

import dataclasses

import torch

from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.models import (
    Discriminator,
    Generator,
    build_for_regime,
    specs_for_regime,
)
from video_filler_tpu_torch.ops import image as image_ops
from video_filler_tpu_torch.ops import losses, masks
from video_filler_tpu_torch.ops.cuda.fused_loss import fused_weighted_mse

METRIC_KEYS = ("errD", "errD_real", "errD_fake", "errG", "errG_l2",
               "errG_gdl", "errG_total")


@dataclasses.dataclass
class TrainState:
    gen: Generator
    disc: Discriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    step: int = 0


def unsupported_step_options(opt: Opt) -> list[str]:
    """Step options of the JAX package this port does not run yet, each
    with the ROADMAP item that brings it."""
    out = []
    if opt.gradAccum > 1:
        out.append("gradAccum>1 is not ported yet (ROADMAP A.8)")
    if opt.remat:
        out.append("remat is not ported yet (ROADMAP A.8)")
    if opt.adamMomentsBf16:
        out.append("adamMomentsBf16 is not ported yet (ROADMAP A.8)")
    if opt.wtgdl != 0.0:
        out.append("wtgdl (the GDL term) is not ported yet (ROADMAP A.7)")
    return out


def _optimizers(opt: Opt, gen: Generator, disc: Discriminator):
    """Two Adams; G's LR is 10x D's when 0<wtl2<1 (train.lua:218-226)."""
    g_lr = opt.lr * 10.0 if 0.0 < opt.wtl2 < 1.0 else opt.lr
    adam = lambda params, lr: torch.optim.Adam(  # noqa: E731
        params, lr=lr, betas=(opt.beta1, 0.999), eps=1e-8)
    return adam(gen.parameters(), g_lr), adam(disc.parameters(), opt.lr)


def init_train_state(opt: Opt, regime: str,
                     gen: torch.Generator) -> TrainState:
    """Networks initialised from ``gen`` (a CPU generator: conv N(0,0.02),
    BN gamma N(1,0.02)), moved to ``opt.device``, with fresh Adams."""
    device = resolve_device(opt)
    g, d = build_for_regime(opt, regime, gen)
    g, d = g.to(device), d.to(device)
    opt_g, opt_d = _optimizers(opt, g, d)
    return TrainState(g, d, opt_g, opt_d)


def make_train_step(opt: Opt, regime: str):
    """Build ``step(state, batch) -> metrics`` for the center regime.

    batch: {'real': (B, fineSize, fineSize, nc) f32 in [-1,1]} on the
    state's device.  metrics: 0-dim f32 tensors on that device, keyed
    ``METRIC_KEYS``; reading them is the caller's choice of sync point."""
    specs_for_regime(opt, regime)  # raises on what is not ported yet
    bad = unsupported_step_options(opt)
    if bad:
        raise NotImplementedError("; ".join(bad))
    device = resolve_device(opt)
    wtl2 = float(opt.wtl2)
    adv_coef = (1.0 - wtl2) if 0.0 < wtl2 < 1.0 else 1.0
    half = opt.fineSize // 2
    if opt.overlapPred > 0:
        l2_w = losses.overlap_l2_weights((half, half), opt.overlapPred, wtl2,
                                         device=device)[None]
    else:
        l2_w = torch.tensor(wtl2, dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def step(state: TrainState, batch) -> dict[str, torch.Tensor]:
        real = batch["real"]
        target = masks.extract_center(real)
        ctx = masks.center_mask_fill(real, opt.overlapPred)
        gen, disc = state.gen.train(), state.disc.train()

        fake = gen(ctx)
        # D loss: real pass then fake pass, BN statistics updated in that
        # order (train.lua:299-345); the fake is detached.
        logit_real = disc(target)
        logit_fake = disc(fake.detach())
        err_d_real = losses.bce_with_logits(logit_real, 1.0)
        err_d_fake = losses.bce_with_logits(logit_fake, 0.0)
        loss_d = err_d_real + err_d_fake

        # G adversarial term: D again on the fake, batch statistics, running
        # statistics untouched (the reference reuses fDx's output,
        # train.lua:365).
        err_g = losses.bce_with_logits(disc(fake, update_stats=False), 1.0)
        loss_g = adv_coef * err_g
        err_g_l2 = zero
        if wtl2 != 0.0:
            err_g_l2 = losses.mse(fake.detach(), target)
            loss_g = loss_g + fused_weighted_mse(fake, target, l2_w)

        state.opt_g.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)
        loss_d.backward(inputs=list(disc.parameters()))
        loss_g.backward(inputs=list(gen.parameters()))
        state.opt_g.step()
        state.opt_d.step()
        state.step += 1
        return {"errD": loss_d.detach(), "errD_real": err_d_real.detach(),
                "errD_fake": err_d_fake.detach(), "errG": err_g.detach(),
                "errG_l2": err_g_l2, "errG_gdl": zero,
                "errG_total": loss_g.detach()}

    return step


def make_preprocess(opt: Opt, regime: str):
    """Device-side preprocessing of a host uint8 batch:
    ``preprocess(batch, gen=None, draws=None) -> {'real': ...}``.

    batch['raw']: (B,H,W,nc) uint8 on the device, H,W >= fineSize.  Crop
    offsets and flips come from ``draws`` ({'y0','x0','flip'}) when given,
    else they are drawn from the CPU generator ``gen`` (``center_draws``)."""
    specs_for_regime(opt, regime)  # raises on what is not ported yet
    fs = opt.fineSize

    def center(batch, gen: torch.Generator | None = None,
               draws: dict | None = None):
        x = batch["raw"]
        if draws is None:
            draws = center_draws(opt, gen, x.shape)
        if x.shape[1] != fs or x.shape[2] != fs:
            x = image_ops.random_crop(x, fs, draws["y0"], draws["x0"])
        x = image_ops.normalize_uint8(x)
        return {"real": image_ops.random_hflip(x, draws["flip"])}

    return center


def center_draws(opt: Opt, gen: torch.Generator,
                 raw_shape: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """The center preprocess's random decisions: crop offsets (B,) and
    flips (B,) bool, drawn on the CPU from ``gen``."""
    b, h, w = raw_shape[:3]
    y0, x0 = image_ops.draw_crop_offsets(gen, b, h, w, opt.fineSize)
    return {"y0": y0, "x0": x0, "flip": image_ops.draw_flips(gen, b)}
