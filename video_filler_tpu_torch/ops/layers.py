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
               eps: float = BN_EPS, group=None,
               replicas: int = 1) -> torch.Tensor:
    """``nn.SpatialBatchNormalization`` with Torch semantics.

    Training: normalize by the biased batch variance; when ``update_stats``,
    update the running statistics in place, the variance with the unbiased
    estimate.  ``update_stats=False``, or a ``running_stats_frozen`` block,
    uses batch statistics and leaves the running ones as they are.  Eval: running statistics.  Statistics in f32;
    the output comes back in x's dtype.

    ``group`` (a process group, training only): the batch statistics are
    those of the union of the group's batches (``_global_batch_norm``),
    where each batch is held by ``replicas`` ranks of the group alike."""
    if training and group is not None:
        return _global_batch_norm(
            x, weight, bias, running_mean, running_var, group, replicas,
            update=update_stats and not getattr(_FROZEN, "on", False),
            momentum=momentum, eps=eps)
    if training and not update_stats:
        running_mean = running_var = None
    elif getattr(_FROZEN, "on", False):
        # Momentum 0 writes each running statistic back unchanged, and the
        # call saves the same tensors for backward as the forward it
        # replays (torch.utils.checkpoint checks that).
        momentum = 0.0
    return F.batch_norm(x, running_mean, running_var, weight, bias,
                        training=training, momentum=momentum, eps=eps)


def _global_batch_norm(x, weight, bias, running_mean, running_var, group,
                       replicas: int = 1, *, update: bool, momentum: float,
                       eps: float):
    """Training-mode BatchNorm over a process group's batches, two-pass in
    f32: the per-channel sums and the element count summed over the group,
    the global mean, then the sum of squared deviations from it summed over
    the group.  The biased variance normalizes; the running variance takes
    the unbiased estimate over the global count.  The sums are all-reduces
    whose backward is the same all-reduce (parallel/comm.py), so the
    gradients are those of BatchNorm over the union of the batches.

    ``replicas``: how many ranks of the group hold each batch (the model
    ranks of a TP data group, whose replicated layers see the same rows):
    each contributes 1/replicas of its sums.  The statistics are then
    reduced over every rank that holds a copy of the layer, so the copies'
    running statistics stay equal even where their convs round
    differently."""
    from video_filler_tpu_torch.parallel import comm

    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float()
    c = x.shape[1]
    count = torch.full((1,), x.numel() // c, dtype=torch.float32,
                       device=x.device)
    local = torch.cat([xf.sum(dims), count])
    share = (lambda t: t) if replicas == 1 else (lambda t: t / replicas)
    sums = comm.all_reduce_sum(share(local), group)
    n = sums[c].detach()
    mean = sums[:c] / n
    dev = xf - mean.reshape(shape)
    var = comm.all_reduce_sum(share(dev.square().sum(dims)), group) / n
    y = dev * torch.rsqrt(var + eps).reshape(shape)
    y = y * weight.reshape(shape) + bias.reshape(shape)
    if update:
        with torch.no_grad():
            unbiased = var * (n / (n - 1).clamp(min=1))
            running_mean.mul_(1 - momentum).add_(mean.detach(),
                                                 alpha=momentum)
            running_var.mul_(1 - momentum).add_(unbiased.detach(),
                                                alpha=momentum)
    return y.to(x.dtype)


class ConvBase(nn.Module):
    """A conv: its ``weight`` (the port's layout), an optional ``bias`` of
    ``cout`` (None when bias-free), stride, padding and compute dtype, and
    the reference's N(0, 0.02) init with a zero bias.  The 2-D and 3-D
    (ops/layers3d.py) convs derive from it."""

    # The sharded builds' collectives around the conv (parallel/mesh.py
    # ``parallelize``): ``pre`` on the input, ``post`` on the output before
    # the bias.  None on the single-device path.
    pre = None
    post = None

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The conv (a subclass's ``conv``) between the ``pre`` and ``post``
        collectives, then the bias."""
        if self.pre is not None:
            x = self.pre(x)
        y = self.conv(x)
        if self.post is not None:
            y = self.post(y)
        return self.add_bias(y)


class Conv2d(ConvBase):

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2,
                 padding: int = 1, dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__((cout, cin, kernel, kernel), cout, stride, padding,
                         dtype, bias)

    def conv(self, x):
        return conv2d(x, self.weight, self.stride, self.padding, self.dtype)


class ConvTranspose2d(ConvBase):

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2,
                 padding: int = 1, dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__((cin, cout, kernel, kernel), cout, stride, padding,
                         dtype, bias)

    def conv(self, x):
        return conv2d_transpose(x, self.weight, self.stride, self.padding,
                                self.dtype)


class BatchNorm(nn.Module):
    """Parameters ``weight`` (gamma) and ``bias`` (beta); buffers
    ``running_mean`` and ``running_var``.  ``group``: the process group
    whose batches share the statistics, ``replicas`` ranks of it holding
    each batch (parallel/mesh.py ``parallelize``); None on one device."""

    group = None
    replicas = 1

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
                          update_stats=update_stats, group=self.group,
                          replicas=self.replicas)


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
