"""Context-encoder generator and discriminator for the center regime
(counterpart of video_filler_tpu/models/context_encoder.py).

* encoder ladder + 64-out decoder:  train.lua:87-148
* 64-in discriminator:              train.lua:181-199

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
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class DiscriminatorSpec:
    nc_in: int
    ndf: int = 64
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _lrelu():
    return nn.LeakyReLU(0.2)


class Generator(nn.Module):
    """Encoder -> BN + LeakyReLU bottleneck -> transposed-conv decoder ->
    Tanh; 64x64 out (the 128-out decoders come with ROADMAP A.7)."""

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
            "up4": ConvTranspose2d(ngf, spec.nc_out, 4, 2, 1, dt),
            "tanh": nn.Tanh(),
        })

    def forward(self, x: torch.Tensor, update_stats: bool = True):
        """x: (B,H,W,nc_in) in [-1,1] -> (B,64,64,nc_out) in the compute
        dtype.  In train mode BN uses batch statistics and, when
        ``update_stats``, updates the running ones."""
        h = self.enc(x.permute(0, 3, 1, 2), update_stats)
        h = self.bott_act(self.bott_bn(h, update_stats))
        return self.dec(h, update_stats).permute(0, 2, 3, 1)


class Discriminator(Sequential):
    """64-in patch discriminator: conv head, three conv+BN stages, a 4x4
    valid conv to one logit per sample."""

    def __init__(self, spec: DiscriminatorSpec):
        ndf, dt = spec.ndf, spec.compute_dtype
        super().__init__({
            "conv1": Conv2d(spec.nc_in, ndf, 4, 2, 1, dt), "lrelu1": _lrelu(),
            "conv2": Conv2d(ndf, ndf * 2, 4, 2, 1, dt),
            "bn2": BatchNorm(ndf * 2), "lrelu2": _lrelu(),
            "conv3": Conv2d(ndf * 2, ndf * 4, 4, 2, 1, dt),
            "bn3": BatchNorm(ndf * 4), "lrelu3": _lrelu(),
            "conv4": Conv2d(ndf * 4, ndf * 8, 4, 2, 1, dt),
            "bn4": BatchNorm(ndf * 8), "lrelu4": _lrelu(),
            "conv5": Conv2d(ndf * 8, 1, 4, 1, 0, dt),
        })

    def forward(self, x: torch.Tensor, update_stats: bool = True):
        """x: (B,64,64,nc_in) -> logits (B,)."""
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
    """(GeneratorSpec, DiscriminatorSpec) for a regime; center only."""
    if regime in ("video", "logo", "wholeim"):
        raise NotImplementedError(
            f"regime={regime!r} is not ported yet (ROADMAP A.7)")
    if regime == "video3d":
        raise NotImplementedError(
            "regime='video3d' is not ported yet (ROADMAP A.13)")
    if regime != "center":
        raise ValueError(f"unknown regime {regime!r}")
    if opt.conditionAdv or opt.noiseGen:
        raise NotImplementedError(
            "conditionAdv and noiseGen are not ported yet (ROADMAP A.8)")
    if opt.useBias:
        raise NotImplementedError(
            "useBias is not ported yet (ROADMAP A.8)")
    g = GeneratorSpec(nc_in=opt.nc, nc_out=opt.nc, nef=opt.nef, ngf=opt.ngf,
                      n_bottleneck=opt.nBottleneck, dtype=opt.computeDtype)
    d = DiscriminatorSpec(nc_in=opt.nc, ndf=opt.ndf, dtype=opt.computeDtype)
    return g, d
