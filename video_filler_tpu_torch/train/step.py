"""The GAN train step (counterpart of video_filler_tpu/train/step.py): the
2-D regimes center, video, logo and wholeim, and the temporal 3-D family
video3d, whose clips are (B,T,H,W,C) with a (B,1,H,W,1) mask.

One step: a G forward, D on the real input and on the detached fake (BN
running statistics updated in that order), D on the fake again for G's
adversarial term, then both gradients at the current weights and two Adam
updates -- the simultaneous form of the reference's fDx/fGx closures
(train.lua:278-409, train.lua:421-424).

The step runs eagerly and updates the ``TrainState`` in place: the networks'
weights and BN buffers and the optimizers' moments.

* G's reconstruction term is ``sum(w * (d_fake - target)**2) / N``,
  computed by the fused CUDA kernel (ops/cuda/fused_loss.py) on every step
  of every regime; ``usePallasLoss`` has no effect here.  The weights keep
  their broadcast shape: the (1,H,W,1) overlap ring (center), wtl2 times the
  (B,H,W,1) mask blend (video), the (B,1,H,W,1) one over T (video3d) or the
  full-size one (wholeim), a 0-dim wtl2 (logo).  ``errG_l2`` is logged
  unweighted.
* Composite fake (video, video3d, wholeim): when ``weight_nomask == 0``, or
  ``compositeLtOne`` and it is < 1, D and the loss see the target with only
  the masked pixels taken from G (train_vid_weighted.lua:429-434,
  train_mycrit.lua:431-437).  ``torch.where`` of a bf16 fake into the f32
  target promotes to f32, as ``jnp.where`` does.
* ``wtgdl`` adds the gradient-difference loss; ``gdlTorchQuirk`` logs its
  value but applies the MSE gradient (train_vid_weighted.lua:524-525).
* ``withInit`` (video, video3d): a pre-trained generator, in eval mode and
  without gradients, fills its prediction into the masked context before G
  runs (train_mycrit.lua:402-405).
* D's parameters get only ``loss_d`` (the fake is detached); G's get only
  ``loss_g``, through the third D pass whose running statistics are not
  updated.  ``backward(inputs=...)`` keeps each loss off the other net.
* Adam: ``torch.optim.Adam(betas=(beta1, 0.999), eps=1e-8)``, which adds eps
  after bias correction, as optax does, or ``AdamBf16Moments`` under
  ``adamMomentsBf16``.  G's learning rate is 10x D's when 0 < wtl2 < 1
  (train.lua:218-222).
* The other step options of the JAX package: ``conditionAdv`` (center only:
  every D pass takes (ctx, x)), ``noiseGen`` (G takes (ctx, z)),
  ``gradAccum``, ``remat`` and ``useBias`` (conv biases trained by Adam, as
  the JAX package trains them, not zeroed as the reference does).
* On a mesh (parallel/mesh.py; ``mesh=`` here and in ``init_train_state``)
  each rank runs the step on its rows (and, on a ('data','seq') mesh, its
  frames) and its objective is a share of the global loss: each loss term,
  a mean over the rank's elements, is scaled by ``1/world`` before the
  backward, so the shares sum to the unsharded loss (every shard has the
  same size; every term is split over an axis or computed alike on each of
  its ranks).  The collectives in the nets have their exact adjoints as
  backward (parallel/comm.py), so after the microbatches each parameter's
  gradient is summed, in one flat bucket per net and group, over the ranks
  that hold a copy of it: the whole mesh for a replicated parameter, the
  data axis for a sharded bottleneck one.  The metrics are the sums of
  the shares (an all_reduce), the unsharded step's metrics.  A data rank
  holds its share of each gradAccum microbatch (parallel/distributed.py
  ``data_rows``), so the microbatches are the unsharded step's; noiseGen's
  z is drawn for the global batch, each data rank taking its rows.
  Without a mesh none of this runs.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.models import (
    build_for_regime,
    check_fine_size,
    specs_for_regime,
)
from video_filler_tpu_torch.ops import image as image_ops
from video_filler_tpu_torch.ops import losses, masks
from video_filler_tpu_torch.ops.cuda.fused_loss import fused_weighted_mse
from video_filler_tpu_torch.ops.layers import running_stats_frozen
from video_filler_tpu_torch.ops.layers3d import unfold_time
from video_filler_tpu_torch.train.optim import AdamBf16Moments

METRIC_KEYS = ("errD", "errD_real", "errD_fake", "errG", "errG_l2",
               "errG_gdl", "errG_total")


@dataclasses.dataclass
class TrainState:
    gen: nn.Module           # models.Generator or Generator3D
    disc: nn.Module
    opt_g: torch.optim.Optimizer   # torch.optim.Adam, or AdamBf16Moments
    opt_d: torch.optim.Optimizer
    step: int = 0
    mesh: object = None      # the DeviceMesh the state is sharded on


def _optimizers(opt: Opt, gen: nn.Module, disc: nn.Module):
    """Two Adams, f32 moments or, with ``adamMomentsBf16``, bf16 ones; G's
    LR is 10x D's when 0<wtl2<1 (train.lua:218-226)."""
    g_lr = opt.lr * 10.0 if 0.0 < opt.wtl2 < 1.0 else opt.lr
    cls = AdamBf16Moments if opt.adamMomentsBf16 else torch.optim.Adam
    adam = lambda params, lr: cls(  # noqa: E731
        params, lr=lr, betas=(opt.beta1, 0.999), eps=1e-8)
    return adam(gen.parameters(), g_lr), adam(disc.parameters(), opt.lr)


def init_train_state(opt: Opt, regime: str, gen: torch.Generator,
                     mesh=None) -> TrainState:
    """Networks initialised from ``gen`` (a CPU generator: conv N(0,0.02),
    BN gamma N(1,0.02)), moved to ``opt.device``, with fresh Adams.  With
    ``mesh``: this rank's networks, with the same draws, their bottleneck
    cut to the rank's shard (parallel/mesh.py ``shard_state``)."""
    device = resolve_device(opt)
    g, d = build_for_regime(opt, regime, gen, mesh)
    g, d = g.to(device), d.to(device)
    opt_g, opt_d = _optimizers(opt, g, d)
    state = TrainState(g, d, opt_g, opt_d, mesh=mesh)
    if mesh is not None:
        from video_filler_tpu_torch.parallel.mesh import shard_state
        shard_state(state, mesh)
    return state


def _reduce_grads(nets, data_group) -> None:
    """Sum each parameter's gradient over the ranks holding a copy of it:
    the world for replicated ones, ``data_group`` for the sharded
    bottleneck ones (flagged ``vf_sharded``); one flat bucket per net and
    group.  A parameter this rank did not use (noiseGen's ``noise`` conv
    off the last model rank) contributes zeros."""
    from video_filler_tpu_torch.parallel import comm

    for net in nets:
        buckets = {False: [], True: []}
        for p in net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            buckets[getattr(p, "vf_sharded", False)].append(p)
        for sharded, params in buckets.items():
            if not params:
                continue
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            comm.all_reduce_(flat, data_group if sharded else None)
            at = 0
            for p in params:
                n = p.numel()
                p.grad.copy_(flat[at:at + n].view_as(p.grad))
                at += n


def check_condition_adv(opt: Opt, regime: str) -> None:
    """conditionAdv is the center trainer's; elsewhere it raises with the
    JAX package's words (video_filler_tpu/train/step.py:144-152)."""
    if opt.conditionAdv and regime != "center":
        raise ValueError(
            f"conditionAdv is only supported for regime=center, not "
            f"{regime!r} (the reference forces it off in its other trainers)")


def draw_noise(opt: Opt, gen: torch.Generator, batch: int,
               device: torch.device | str) -> torch.Tensor:
    """noiseGen's z, (B,1,1,nz) f32, drawn on the CPU from ``gen`` --
    uniform in [-1,1] or standard normal by ``noisetype`` -- and moved to
    ``device`` (train.lua:319-323; the JAX package's ``_draw_noise``)."""
    shape = (batch, 1, 1, opt.nz)
    if opt.noisetype == "uniform":
        z = torch.rand(shape, generator=gen) * 2 - 1
    else:
        z = torch.randn(shape, generator=gen)
    return z.to(device)


def _remat_contexts():
    """torch.utils.checkpoint's context_fn: the forward as it is, the
    recompute with BN running-statistic updates off."""
    return contextlib.nullcontext(), running_stats_frozen()


def make_train_step(opt: Opt, regime: str, with_init: bool = False,
                    mesh=None):
    """Build ``step(state, batch, init_net=None, noise=None, gen=None) ->
    metrics`` for a regime.  ``mesh``: the step of one rank (see the
    module's docstring); ``batch`` then holds its rows (and frames), and
    ``noise``, when given, the global batch's.

    batch (on the state's device, NHWC float in [-1,1] unless noted):
      center : {'real': (B,fs,fs,nc)}
      video  : {'real': (B,fs,fs,nc*predLen), 'mask': (B,fs,fs,1) {0,1}}
      logo   : {'real': gt, 'masked': masked input}
      wholeim: {'real': (B,fs,fs,nc*4) target patches, 'mask': same-shape
                {0,1}, 'masked': (B,fs,fs,nc*arrh*arrw) input patch array}
      video3d: {'real': (B,T,fs,fs,nc) contiguous, 'mask': (B,1,fs,fs,1)}
    ``init_net`` (with_init only): the initializer generator.  noiseGen: G
    takes (ctx, z); z is ``noise`` (B,1,1,nz) when given (the JAX side's
    draw in a test), else drawn from the CPU generator ``gen``
    (``draw_noise``).  metrics: 0-dim f32 tensors on the device, keyed
    ``METRIC_KEYS``; reading them is the caller's choice of sync point.

    gradAccum=n: the withInit cascade and the noise draw run on the whole
    batch; then every operand whose first dim is the batch (ctx, the D
    input, the target, (B,...) l2 weights, the mask, z) splits into n
    microbatches -- the center ring weights (1,H,W,1) and a 0-dim wtl2
    stay whole -- each runs forward and backward (BN batch statistics per
    microbatch, running statistics chained through them), the summed
    gradients and metrics are scaled by 1/n, and each net takes one Adam
    update.  remat: G's apply and each D apply run under
    ``torch.utils.checkpoint`` (non-reentrant), their recompute with BN
    running-statistic updates off."""
    specs_for_regime(opt, regime)  # conditionAdv/noiseGen on video3d raise
    check_fine_size(opt, regime)
    check_condition_adv(opt, regime)
    if with_init and regime not in ("video", "video3d"):
        # The cascade composites netI's prediction inside the mask
        # (train_mycrit.lua:402-405); only the video trainers define it.
        raise ValueError(
            f"withInit requires a video regime (video, video3d), not "
            f"{regime!r}")
    device = resolve_device(opt)
    wtl2 = float(opt.wtl2)
    adv_coef = (1.0 - wtl2) if 0.0 < wtl2 < 1.0 else 1.0
    lam = float(opt.weight_nomask)
    n_micro = int(opt.gradAccum)
    wtl2_t = torch.tensor(wtl2, dtype=torch.float32, device=device)
    composite = regime in ("video", "video3d", "wholeim") and (
        lam == 0.0 or (opt.compositeLtOne and lam < 1.0))
    if regime == "center" and opt.overlapPred > 0:
        half = opt.fineSize // 2
        ring = losses.overlap_l2_weights((half, half), opt.overlapPred, wtl2,
                                         device=device)[None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    share = None
    if mesh is not None:
        from video_filler_tpu_torch.parallel import comm
        from video_filler_tpu_torch.parallel.distributed import data_rows
        from video_filler_tpu_torch.parallel.mesh import coords
        where = coords(mesh)
        share = 1.0 / where.world
        data_group = mesh.get_group("data")
        seq_group = (mesh.get_group("seq") if where.shard_axis == "seq"
                     else None)

    def apply(net, *args, **kw):
        if not opt.remat:
            return net(*args, **kw)
        return checkpoint(net, *args, use_reentrant=False,
                          context_fn=_remat_contexts, **kw)

    def prepare(batch):
        """(ctx, d_real, target, l2 weights, mask) for the regime."""
        if regime == "center":
            real = batch["real"]
            target = masks.extract_center(real)
            ctx = masks.center_mask_fill(real, opt.overlapPred)
            w = ring if opt.overlapPred > 0 else wtl2_t
            return ctx, target, target, w, None
        real = batch["real"]
        if regime == "logo":
            return batch["masked"], real, real, wtl2_t, None
        mask = batch["mask"]                       # video, video3d, wholeim
        ctx = (batch["masked"] if regime == "wholeim"
               else masks.apply_logo_mask(real, mask, opt.maskValue))
        w = wtl2_t * losses.mask_l2_weights(mask.float(), lam)
        return ctx, real, real, w, mask

    def forward_backward(gen, disc, ctx, d_real, target, l2_w, mask, noise):
        """One (micro)batch: the forwards, both losses, their backward into
        the nets' ``.grad`` (summed onto what is there); the metrics."""
        fake = apply(gen, (ctx, noise) if opt.noiseGen else ctx)
        d_fake = masks.fill_in(target, mask, fake) if composite else fake
        d_in = (lambda x: (ctx, x)) if opt.conditionAdv else (lambda x: x)
        # D loss: real pass then fake pass, BN statistics updated in that
        # order (train.lua:299-345); the fake is detached.
        logit_real = apply(disc, d_in(d_real))
        logit_fake = apply(disc, d_in(d_fake.detach()))
        err_d_real = losses.bce_with_logits(logit_real, 1.0)
        err_d_fake = losses.bce_with_logits(logit_fake, 0.0)
        loss_d = err_d_real + err_d_fake

        # G adversarial term: D again on the fake, batch statistics, running
        # statistics untouched (the reference reuses fDx's output,
        # train.lua:365).
        err_g = losses.bce_with_logits(
            apply(disc, d_in(d_fake), update_stats=False), 1.0)
        loss_g = adv_coef * err_g
        err_g_l2 = zero
        if wtl2 != 0.0:
            err_g_l2 = losses.mse(d_fake.detach(), target)
            loss_g = loss_g + fused_weighted_mse(d_fake, target, l2_w)
        err_g_gdl = zero
        if opt.wtgdl != 0.0:
            gdl_val = losses.gdl(d_fake, target)
            if opt.gdlTorchQuirk:
                # Reference bug: GDL forward logged, MSE gradient applied
                # (train_vid_weighted.lua:524-525).
                mse = losses.mse(d_fake, target)
                loss_g = loss_g + opt.wtgdl * (
                    mse - mse.detach() + gdl_val.detach())
            else:
                loss_g = loss_g + opt.wtgdl * gdl_val
            err_g_gdl = gdl_val.detach()

        if share is None:
            loss_d.backward(inputs=list(disc.parameters()))
            loss_g.backward(inputs=list(gen.parameters()))
        else:   # this rank's shares of the global losses
            (loss_d * share).backward(inputs=list(disc.parameters()))
            (loss_g * share).backward(inputs=list(gen.parameters()))
        return {"errD": loss_d.detach(), "errD_real": err_d_real.detach(),
                "errD_fake": err_d_fake.detach(), "errG": err_g.detach(),
                "errG_l2": err_g_l2, "errG_gdl": err_g_gdl,
                "errG_total": loss_g.detach()}

    def step(state: TrainState, batch, init_net: nn.Module | None = None,
             noise: torch.Tensor | None = None,
             gen: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        ctx, d_real, target, l2_w, mask = prepare(batch)
        if with_init:
            with torch.no_grad():
                if share is not None and seq_group is not None:
                    # netI is replicated: it runs on the whole clip, and
                    # this rank keeps its frames
                    t = ctx.shape[1]
                    fake_init = init_net.eval()(comm.all_gather(
                        ctx, seq_group, dim=1)).narrow(
                            1, where.shard_rank * t, t)
                else:
                    fake_init = init_net.eval()(ctx)
            ctx = masks.fill_in(ctx, mask, fake_init)
        if opt.noiseGen and noise is None:
            if gen is None:
                raise ValueError("a noiseGen step takes noise= or gen= (the "
                                 "generator its z is drawn from)")
            rows = ctx.shape[0] * (where.n_data if share is not None else 1)
            noise = draw_noise(opt, gen, rows, ctx.device)
        if share is not None and opt.noiseGen:
            noise = noise[data_rows(ctx.shape[0] * where.n_data,
                                    where.n_data, where.data_rank,
                                    n_micro).to(noise.device)]
        operands = (ctx, d_real, target, l2_w, mask, noise)
        b = ctx.shape[0]
        if b % n_micro != 0:
            raise ValueError(f"batchSize {b} must divide by gradAccum "
                             f"{n_micro}")
        m = b // n_micro
        split = [isinstance(x, torch.Tensor) and x.dim() > 0
                 and x.shape[0] == b for x in operands]
        state.opt_g.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)
        gen_net, disc = state.gen.train(), state.disc.train()
        total = None
        for i in range(n_micro):
            mb = [x[i * m:(i + 1) * m] if s else x
                  for x, s in zip(operands, split)]
            metrics = forward_backward(gen_net, disc, *mb)
            total = metrics if total is None else {
                k: total[k] + v for k, v in metrics.items()}
        if n_micro > 1:
            inv = 1.0 / n_micro
            for p in (*gen_net.parameters(), *disc.parameters()):
                if p.grad is not None:
                    p.grad.mul_(inv)
            total = {k: v * inv for k, v in total.items()}
        if share is not None:
            _reduce_grads((gen_net, disc), data_group)
            vals = torch.stack([total[k] for k in METRIC_KEYS]) * share
            comm.all_reduce_(vals)
            total = dict(zip(METRIC_KEYS, vals.unbind()))
        state.opt_g.step()
        state.opt_d.step()
        state.step += 1
        return total

    return step


def make_preprocess(opt: Opt, regime: str):
    """Device-side preprocessing of a host uint8 batch:
    ``preprocess(batch, gen=None, draws=None) -> step batch``.

    The random decisions come from ``draws`` when given (the regime's
    ``*_draws`` dict, e.g. the JAX side's in a test), else they are drawn
    from the CPU generator ``gen``."""
    specs_for_regime(opt, regime)  # raises on what the regime refuses
    check_fine_size(opt, regime)
    fs = opt.fineSize

    def crop(x, draws):
        if x.shape[1] != fs or x.shape[2] != fs:
            x = image_ops.random_crop(x, fs, draws["y0"], draws["x0"])
        return x

    def center(batch, gen=None, draws=None):
        """batch['raw']: (B,H,W,nc) uint8, H,W >= fineSize."""
        x = batch["raw"]
        if draws is None:
            draws = center_draws(opt, gen, x.shape)
        x = image_ops.normalize_uint8(crop(x, draws))
        return {"real": image_ops.random_hflip(x, draws["flip"])}

    def video(batch, gen=None, draws=None):
        """batch['raw']: (B,H,W,nc*predLen) uint8 channel-folded clip;
        batch['mask']: (B,H,W,1) or unbatched (H,W,1) uint8 {0,1}.  Clip and
        mask share one crop.  Default donkey: an empty mask crop falls back
        to random blocks, and clip and mask flip together
        (datavid/donkey_folder.lua:161-180).  donkey_file=...norandblk...:
        no fallback, and only the clip flips -- the mask stays frame-fixed
        (donkey_folder_norandblk.lua:141-158)."""
        raw, mask = batch["raw"], batch["mask"]
        if mask.dim() == 3:
            mask = mask[None].expand((raw.shape[0],) + tuple(mask.shape))
        if draws is None:
            draws = video_draws(opt, gen, raw.shape)
        raw, mask = crop(raw, draws), crop(mask, draws)
        x = image_ops.normalize_uint8(raw)
        m = mask.float()
        if opt.noRandBlk:
            x = image_ops.random_hflip(x, draws["flip"])
        else:
            m = masks.mask_or_random_block(m, draws["blocks"])
            x, m = image_ops.random_hflip(x, draws["flip"], m)
        return {"real": x, "mask": m}

    def logo(batch, gen=None, draws=None):
        """Masked/gt pairs share the flip (donkey_folder_logo.lua:91-98)."""
        xm = image_ops.normalize_uint8(batch["raw_masked"])
        xg = image_ops.normalize_uint8(batch["raw_gt"])
        if draws is None:
            draws = logo_draws(opt, gen, xm.shape)
        xm, xg = image_ops.random_hflip(xm, draws["flip"], xg)
        return {"masked": xm, "real": xg}

    def wholeim(batch, gen=None, draws=None):
        """Patch arrays arrive sliced and flipped on the host
        (donkey_wholeim.lua:177-181); only normalisation here."""
        return {"masked": image_ops.normalize_uint8(batch["raw_masked"]),
                "real": image_ops.normalize_uint8(batch["raw_real"]),
                "mask": batch["mask"].float()}

    def video3d(batch, gen=None, draws=None):
        """The video preprocess, then the clip unfolded to (B,T,H,W,C) and
        made contiguous (the JAX arrays have no strides; here the kernel's
        row path and cuDNN's channels_last_3d read it in place); the
        (B,H,W,1) mask gains a T axis of 1 that broadcasts over the
        frames."""
        out = video(batch, gen, draws)
        return {"real": unfold_time(out["real"], opt.predLen).contiguous(),
                "mask": out["mask"][:, None]}

    return {"center": center, "video": video, "logo": logo,
            "wholeim": wholeim, "video3d": video3d}[regime]


def global_draws(opt: Opt, regime: str, gen: torch.Generator,
                 local_shape: tuple[int, ...], n_data: int,
                 data_rank: int) -> dict:
    """A data rank's rows (``data_rows``) of the preprocess decisions drawn
    for the global batch (``n_data`` ranks of ``local_shape[0]`` rows), so
    that a sharded run makes the unsharded run's decisions."""
    from video_filler_tpu_torch.parallel.distributed import data_rows
    draw = {"center": center_draws, "video": video_draws,
            "video3d": video_draws, "logo": logo_draws,
            "wholeim": wholeim_draws}[regime]
    n = local_shape[0] * n_data
    full = draw(opt, gen, (n,) + tuple(local_shape[1:]))
    mine = data_rows(n, n_data, data_rank, int(opt.gradAccum))

    def rows(d):
        if isinstance(d, dict):
            return {k: rows(v) for k, v in d.items()}
        return d[mine]
    return rows(full)


def center_draws(opt: Opt, gen: torch.Generator,
                 raw_shape: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """The center preprocess's random decisions: crop offsets (B,) and
    flips (B,) bool, drawn on the CPU from ``gen``."""
    b, h, w = raw_shape[:3]
    y0, x0 = image_ops.draw_crop_offsets(gen, b, h, w, opt.fineSize)
    return {"y0": y0, "x0": x0, "flip": image_ops.draw_flips(gen, b)}


def video_draws(opt: Opt, gen: torch.Generator,
                raw_shape: tuple[int, ...]) -> dict:
    """The video preprocess's decisions: a crop shared by clip and mask,
    the random-block masks (used where a mask crop is empty, unless
    norandblk) and the flips."""
    out = center_draws(opt, gen, raw_shape)
    out["blocks"] = masks.random_block_draws(gen, raw_shape[0], opt.fineSize,
                                             opt.fineSize)
    return out


def logo_draws(opt: Opt, gen: torch.Generator,
               raw_shape: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """The logo preprocess's decisions: flips (B,) shared by the pair."""
    return {"flip": image_ops.draw_flips(gen, raw_shape[0])}


def wholeim_draws(opt: Opt, gen: torch.Generator,
                  raw_shape: tuple[int, ...]) -> dict:
    """The wholeim preprocess draws nothing: its randomness is host-side."""
    return {}
