"""Context-encoder generators and discriminators for the 2-D regimes
(counterpart of video_filler_tpu/models/context_encoder.py).

* encoder ladder + 64-out decoder:      train.lua:87-148
* 128-out video decoder (ngf mid):      train_vid_weighted.lua:171-176
* 128-out logo decoder (ngf/2 mid):     train_logo_withmask.lua:154-158
* wholeim in/out widths:                train_wholeim_input.lua:118-119
* 64-in discriminator:                  train.lua:181-199
* 128-in discriminator (no BN on the
  two leading convs):                   train_vid_weighted.lua:216-227

The models take and return (B,H,W,C) tensors, the JAX package's layout;
inside they run NCHW with channels-last memory.  Discriminators return
LOGITS of shape (B,): the reference's Sigmoid + BCECriterion
(train.lua:197,207) is a logit-space BCE in the step.  Layer names match
the JAX parameter trees, so state-dict keys are their dotted paths
(checkpoint/convert.py).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.ops.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    Sequential,
    reset_parameters,
)


@dataclasses.dataclass(frozen=True)
class GeneratorSpec:
    nc_in: int
    nc_out: int
    nef: int = 64
    ngf: int = 64
    n_bottleneck: int = 4000
    out_size: int = 128              # 64 (center) or 128 (video/logo/wholeim)
    mid_channels: int | None = None  # 64->128 stage width; None = ngf (video),
                                     # logo uses ngf//2
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class DiscriminatorSpec:
    nc_in: int
    ndf: int = 64
    in_size: int = 64                # 64 (center) or 128 (full-image D)
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _lrelu():
    return nn.LeakyReLU(0.2)


def _decoder_tail(spec: GeneratorSpec, dt: torch.dtype) -> dict:
    """The decoder after its 32x32 stage: one up-conv to nc_out at 64 out;
    at 128 out a mid stage (up4/bn4/relu4, width ngf or ngf//2) first."""
    ngf = spec.ngf
    if spec.out_size == 64:
        return {"up4": ConvTranspose2d(ngf, spec.nc_out, 4, 2, 1, dt)}
    if spec.out_size == 128:
        mid = spec.mid_channels if spec.mid_channels is not None else ngf
        return {"up4": ConvTranspose2d(ngf, mid, 4, 2, 1, dt),
                "bn4": BatchNorm(mid), "relu4": nn.ReLU(),
                "up5": ConvTranspose2d(mid, spec.nc_out, 4, 2, 1, dt)}
    raise ValueError(f"out_size must be 64 or 128, got {spec.out_size}")


class Generator(nn.Module):
    """Encoder -> BN + LeakyReLU bottleneck -> transposed-conv decoder ->
    Tanh; 64x64 or 128x128 out."""

    def __init__(self, spec: GeneratorSpec):
        super().__init__()
        nef, ngf, dt = spec.nef, spec.ngf, spec.compute_dtype
        nb = spec.n_bottleneck
        self.enc = Sequential({
            "conv0": Conv2d(spec.nc_in, nef, 4, 2, 1, dt), "lrelu0": _lrelu(),
            "conv1": Conv2d(nef, nef, 4, 2, 1, dt), "bn1": BatchNorm(nef),
            "lrelu1": _lrelu(),
            "conv2": Conv2d(nef, nef * 2, 4, 2, 1, dt),
            "bn2": BatchNorm(nef * 2), "lrelu2": _lrelu(),
            "conv3": Conv2d(nef * 2, nef * 4, 4, 2, 1, dt),
            "bn3": BatchNorm(nef * 4), "lrelu3": _lrelu(),
            "conv4": Conv2d(nef * 4, nef * 8, 4, 2, 1, dt),
            "bn4": BatchNorm(nef * 8), "lrelu4": _lrelu(),
            "conv5": Conv2d(nef * 8, nb, 4, 1, 0, dt),
        })
        self.bott_bn = BatchNorm(nb)
        self.bott_act = _lrelu()
        self.dec = Sequential({
            "up0": ConvTranspose2d(nb, ngf * 8, 4, 1, 0, dt),
            "bn0": BatchNorm(ngf * 8), "relu0": nn.ReLU(),
            "up1": ConvTranspose2d(ngf * 8, ngf * 4, 4, 2, 1, dt),
            "bn1": BatchNorm(ngf * 4), "relu1": nn.ReLU(),
            "up2": ConvTranspose2d(ngf * 4, ngf * 2, 4, 2, 1, dt),
            "bn2": BatchNorm(ngf * 2), "relu2": nn.ReLU(),
            "up3": ConvTranspose2d(ngf * 2, ngf, 4, 2, 1, dt),
            "bn3": BatchNorm(ngf), "relu3": nn.ReLU(),
            **_decoder_tail(spec, dt),
            "tanh": nn.Tanh(),
        })

    def forward(self, x: torch.Tensor, update_stats: bool = True):
        """x: (B,H,W,nc_in) in [-1,1] -> (B,S,S,nc_out), S = out_size, in
        the compute dtype.  In train mode BN uses batch statistics and, when
        ``update_stats``, updates the running ones."""
        h = self.enc(x.permute(0, 3, 1, 2), update_stats)
        h = self.bott_act(self.bott_bn(h, update_stats))
        # The (B,nb,1,1) bottleneck has NCHW strides, which PyTorch reads as
        # the NCHW format: the decoder would run NCHW and G's output,
        # permuted back, would not be contiguous (B,H,W,C).  The same memory
        # with channels-last strides keeps the decoder channels-last.
        h = h.reshape(h.shape[0], 1, 1, h.shape[1]).permute(0, 3, 1, 2)
        return self.dec(h, update_stats).permute(0, 2, 3, 1)


class Discriminator(Sequential):
    """Patch discriminator: a BN-free conv head (one conv at 64 in; at 128 in
    conv0 to ndf/2 then conv1 to ndf), three conv+BN stages, a 4x4 valid
    conv to one logit per sample."""

    def __init__(self, spec: DiscriminatorSpec):
        ndf, dt = spec.ndf, spec.compute_dtype
        if spec.in_size == 64:
            head = {"conv1": Conv2d(spec.nc_in, ndf, 4, 2, 1, dt),
                    "lrelu1": _lrelu()}
        elif spec.in_size == 128:
            head = {"conv0": Conv2d(spec.nc_in, ndf // 2, 4, 2, 1, dt),
                    "lrelu0": _lrelu(),
                    "conv1": Conv2d(ndf // 2, ndf, 4, 2, 1, dt),
                    "lrelu1": _lrelu()}
        else:
            raise ValueError(f"in_size must be 64 or 128, got {spec.in_size}")
        super().__init__({
            **head,
            "conv2": Conv2d(ndf, ndf * 2, 4, 2, 1, dt),
            "bn2": BatchNorm(ndf * 2), "lrelu2": _lrelu(),
            "conv3": Conv2d(ndf * 2, ndf * 4, 4, 2, 1, dt),
            "bn3": BatchNorm(ndf * 4), "lrelu3": _lrelu(),
            "conv4": Conv2d(ndf * 4, ndf * 8, 4, 2, 1, dt),
            "bn4": BatchNorm(ndf * 8), "lrelu4": _lrelu(),
            "conv5": Conv2d(ndf * 8, 1, 4, 1, 0, dt),
        })

    def forward(self, x: torch.Tensor, update_stats: bool = True):
        """x: (B,S,S,nc_in), S = in_size -> logits (B,)."""
        y = super().forward(x.permute(0, 3, 1, 2), update_stats)
        return y.reshape(y.shape[0])


def build_generator(spec: GeneratorSpec, gen: torch.Generator) -> Generator:
    """A generator on the CPU with the reference init drawn from ``gen``."""
    net = Generator(spec)
    reset_parameters(net, gen)
    return net


def build_discriminator(spec: DiscriminatorSpec,
                        gen: torch.Generator) -> Discriminator:
    """A discriminator on the CPU with the reference init drawn from ``gen``."""
    net = Discriminator(spec)
    reset_parameters(net, gen)
    return net


def specs_for_regime(opt: Opt, regime: str
                     ) -> tuple[GeneratorSpec, DiscriminatorSpec]:
    """(GeneratorSpec, DiscriminatorSpec) for a 2-D regime, mirroring the
    reference trainers:
      center  -> train.lua            (64-out G, 64-in D)
      video   -> train_vid_weighted   (nc*predLen channels, 128 out/in)
      logo    -> train_logo_withmask  (128 out with an ngf//2 mid stage)
      wholeim -> train_wholeim_input  (patch-array in, 2x2 patches out)"""
    if regime == "video3d":
        raise NotImplementedError(
            "regime='video3d' is not ported yet (ROADMAP A.13)")
    if regime not in ("center", "video", "logo", "wholeim"):
        raise ValueError(f"unknown regime {regime!r}")
    if opt.conditionAdv or opt.noiseGen:
        raise NotImplementedError(
            "conditionAdv and noiseGen are not ported yet (ROADMAP A.8)")
    if opt.useBias:
        raise NotImplementedError(
            "useBias is not ported yet (ROADMAP A.8)")
    common = dict(nef=opt.nef, ngf=opt.ngf, n_bottleneck=opt.nBottleneck,
                  dtype=opt.computeDtype)
    dcommon = dict(ndf=opt.ndf, dtype=opt.computeDtype)
    if regime == "center":
        g = GeneratorSpec(nc_in=opt.nc, nc_out=opt.nc, out_size=64, **common)
        d = DiscriminatorSpec(nc_in=opt.nc, in_size=64, **dcommon)
    elif regime == "video":
        nc = opt.nc_total
        g = GeneratorSpec(nc_in=nc, nc_out=nc, out_size=128, **common)
        d = DiscriminatorSpec(nc_in=nc, in_size=128, **dcommon)
    elif regime == "logo":
        g = GeneratorSpec(nc_in=opt.nc, nc_out=opt.nc, out_size=128,
                          mid_channels=opt.ngf // 2, **common)
        d = DiscriminatorSpec(nc_in=opt.nc, in_size=128, **dcommon)
    else:  # wholeim
        g = GeneratorSpec(nc_in=opt.nc_wholeim_in, nc_out=opt.nc_wholeim_out,
                          out_size=128, **common)
        d = DiscriminatorSpec(nc_in=opt.nc_wholeim_out, in_size=128,
                              **dcommon)
    return g, d
