"""NN layers with Torch7 semantics (counterpart of
video_filler_tpu/ops/layers.py).

Layers work on NCHW tensors with PyTorch weight layouts; the models permute
the (B,H,W,C) batch once on the way in, which on a contiguous NHWC tensor
gives the channels-last memory format, so cuDNN runs NHWC end to end.

* Convs are bias-free by default: the reference zeroes every conv bias each
  step (train.lua:279-280).  ``useBias`` gives each conv a ``bias``, zero at
  init and trained by Adam like the weights, added after the conv in the
  compute dtype (``y + b.to(dtype)``), as the JAX layers add it -- not
  through ``F.conv2d(bias=)``, which adds it before the output is rounded.
* Compute dtype: the input and the weight are cast to it before each conv,
  explicitly (no autocast), as the JAX layers do; activations stay in it
  between layers.  Parameters, BN statistics and losses stay f32.
* Weight init: conv N(0, 0.02), BN gamma N(1, 0.02), beta 0
  (train.lua:58-67), drawn from an explicit ``torch.Generator``.

Layouts against the JAX package: a conv weight HWIO maps to OIHW by
``transpose(3,2,0,1)``; a transposed-conv weight (k,k,cin,cout) maps to
(cin,cout,k,k) by ``transpose(2,3,0,1)``, with no spatial flip.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

# Torch BatchNorm defaults (nn.SpatialBatchNormalization).
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
W_STD = 0.02


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int, padding: int,
           dtype: torch.dtype) -> torch.Tensor:
    """``nn.SpatialConvolution`` (cross-correlation) in ``dtype``."""
    return F.conv2d(x.to(dtype), weight.to(dtype), stride=stride,
                    padding=padding)


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor, stride: int,
                     padding: int, dtype: torch.dtype) -> torch.Tensor:
    """``nn.SpatialFullConvolution`` in ``dtype``; weight (cin,cout,k,k).
    One call covers the JAX package's three paths (1x1-input head, sub-pixel
    4x4/stride-2 ladder, input-dilated general case), which are equal."""
    return F.conv_transpose2d(x.to(dtype), weight.to(dtype), stride=stride,
                              padding=padding)


_FROZEN = threading.local()


@contextlib.contextmanager
def running_stats_frozen():
    """Within the block, on this thread, every ``BatchNorm`` in train mode
    leaves its running statistics as they are (it normalises by batch
    statistics either way).  The remat step's recompute runs under it
    (torch.utils.checkpoint's ``context_fn``): a replayed forward must not
    update the statistics a second time."""
    prev = getattr(_FROZEN, "on", False)
    _FROZEN.on = True
    try:
        yield
    finally:
        _FROZEN.on = prev


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               training: bool, update_stats: bool = True,
               momentum: float = BN_MOMENTUM,
               eps: float = BN_EPS) -> torch.Tensor:
    """``nn.SpatialBatchNormalization`` with Torch semantics.

    Training: normalize by the biased batch variance; when ``update_stats``,
    update the running statistics in place, the variance with the unbiased
    estimate.  ``update_stats=False``, or a ``running_stats_frozen`` block,
    uses batch statistics and leaves the running ones as they are.  Eval: running statistics.  Statistics in f32;
    the output comes back in x's dtype."""
    if training and not update_stats:
        running_mean = running_var = None
    elif getattr(_FROZEN, "on", False):
        # Momentum 0 writes each running statistic back unchanged, and the
        # call saves the same tensors for backward as the forward it
        # replays (torch.utils.checkpoint checks that).
        momentum = 0.0
    return F.batch_norm(x, running_mean, running_var, weight, bias,
                        training=training, momentum=momentum, eps=eps)


class ConvBase(nn.Module):
    """A conv: its ``weight`` (the port's layout), an optional ``bias`` of
    ``cout`` (None when bias-free), stride, padding and compute dtype, and
    the reference's N(0, 0.02) init with a zero bias.  The 2-D and 3-D
    (ops/layers3d.py) convs derive from it."""

    def __init__(self, shape: tuple[int, ...], cout: int, stride, padding,
                 dtype: torch.dtype, bias: bool = False):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, W_STD, generator=gen)
            if self.bias is not None:
                self.bias.zero_()

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` plus the bias in y's dtype, broadcast over the channels of
        an NC... tensor (``y + b.astype(dtype)`` in the JAX layers)."""
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 2))


class Conv2d(ConvBase):

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2,
                 padding: int = 1, dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__((cout, cin, kernel, kernel), cout, stride, padding,
                         dtype, bias)

    def forward(self, x):
        return self.add_bias(conv2d(x, self.weight, self.stride, self.padding,
                                    self.dtype))


class ConvTranspose2d(ConvBase):

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2,
                 padding: int = 1, dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__((cin, cout, kernel, kernel), cout, stride, padding,
                         dtype, bias)

    def forward(self, x):
        return self.add_bias(conv2d_transpose(x, self.weight, self.stride,
                                              self.padding, self.dtype))


class BatchNorm(nn.Module):
    """Parameters ``weight`` (gamma) and ``bias`` (beta); buffers
    ``running_mean`` and ``running_var``."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(1.0, W_STD, generator=gen)
            self.bias.zero_()

    def forward(self, x, update_stats: bool = True):
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, training=self.training,
                          update_stats=update_stats)


class Sequential(nn.ModuleDict):
    """Named layers applied in order; ``update_stats`` reaches every
    BatchNorm.  Names follow the JAX package's, so state-dict keys map 1:1."""

    def forward(self, x, update_stats: bool = True):
        for layer in self.values():
            if isinstance(layer, BatchNorm):
                x = layer(x, update_stats)
            else:
                x = layer(x)
        return x


def reset_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Reference init of every layer under ``module``, in definition order."""
    for m in module.modules():
        if isinstance(m, (ConvBase, BatchNorm)):
            m.reset_parameters(gen)
