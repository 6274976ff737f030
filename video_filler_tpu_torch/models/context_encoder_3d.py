"""The temporal (3-D conv) context-encoder family, ``regime=video3d``
(counterpart of video_filler_tpu/models/context_encoder_3d.py).

The reference folds predLen frames into channels and stays 2-D
(train_vid_weighted.lua:96-176); this family keeps the encoder, bottleneck
and decoder shape and the loss, and convolves over (T,H,W) with a temporal
kernel of 3 at every level.  Clips are (B,T,S,S,nc) in [-1,1] with
S = 4 * 2**levels (128 at the default 5 levels); ops/layers3d.fold_time and
unfold_time convert to and from the folded channels.

The models take and return (B,T,H,W,C), the JAX layout; inside they run
NCDHW in ``channels_last_3d`` memory.  Layer names match the JAX trees
(``enc.conv{i}``, ``enc.bn{i}``, ``bott_bn``, ``dec.up{i}``, ``dec.bn{i}``),
so state-dict keys are their dotted paths (checkpoint/convert.py); with
``useBias`` every conv has a ``bias``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from video_filler_tpu_torch.ops.layers import BatchNorm, Sequential
from video_filler_tpu_torch.ops.layers3d import Conv3d, ConvTranspose3d

CL3D = torch.channels_last_3d


@dataclasses.dataclass(frozen=True)
class Video3DSpec:
    nc: int = 3
    pred_len: int = 4
    nef: int = 64
    ngf: int = 64
    ndf: int = 64
    n_bottleneck: int = 4000
    levels: int = 5            # spatial halvings; input side = 4 * 2**levels
    use_bias: bool = False
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def fine_size(self) -> int:
        return 4 * 2 ** self.levels


def _enc_widths(base: int, levels: int) -> list[int]:
    """The reference's channel ladder nef, nef, 2nef, 4nef, 8nef
    (train.lua:87-103) at any depth: doubling, capped at 8x."""
    return [base * min(2 ** max(i - 1, 0), 8) for i in range(levels)]


def _clip_in(spec: Video3DSpec, x: torch.Tensor,
             frames: int | None = None) -> torch.Tensor:
    """A (B,T,S,S,nc) clip as NCDHW in channels_last_3d memory (no copy for a
    contiguous clip).  Any other shape raises: the valid (T,4,4) convs would
    otherwise run on and return a wrong shape.  ``frames``: the T of a
    sequence-parallel rank's chunk (predLen / seqParallel)."""
    s, t = spec.fine_size, frames or spec.pred_len
    if x.dim() != 5 or tuple(x.shape[1:]) != (t, s, s, spec.nc):
        raise ValueError(
            f"the 3-D family takes (B,{t},{s},{s},{spec.nc}) clips "
            f"(S = 4*2**video3dLevels = {s}, T = predLen), got "
            f"{tuple(x.shape)}")
    return x.permute(0, 4, 1, 2, 3).contiguous(memory_format=CL3D)


def _convs(seq_group):
    """(conv, transposed conv) classes of the temporal stages: the plain
    ones, or with ``seq_group`` (a process group) the sequence-parallel
    ones over T-sharded clips (parallel/temporal.py), which keep the
    parameter names and init."""
    if seq_group is None:
        return Conv3d, ConvTranspose3d
    from functools import partial

    from video_filler_tpu_torch.parallel.temporal import (
        SPConv3d,
        SPConvTranspose3d,
    )
    return (partial(SPConv3d, group=seq_group),
            partial(SPConvTranspose3d, group=seq_group))


def _local_frames(spec: Video3DSpec, seq_group) -> int:
    """T of the clips a net takes: predLen, or its share of the seq
    ranks."""
    if seq_group is None:
        return spec.pred_len
    import torch.distributed as dist
    n = dist.get_world_size(seq_group)
    if spec.pred_len % n:
        raise ValueError(f"predLen {spec.pred_len} must divide by "
                         f"seqParallel {n}")
    return spec.pred_len // n


class Generator3D(nn.Module):
    """Encoder: ``levels`` (3,4,4)/(1,2,2) convs down to 4x4, a (T,4,4)
    valid conv to the 1x1x1 bottleneck, BN + LeakyReLU; the decoder mirrors
    it back to (T,S,S,nc) and ends in Tanh.  ``seq_group``: T-sharded
    clips, sequence-parallel temporal convs."""

    def __init__(self, spec: Video3DSpec, seq_group=None):
        super().__init__()
        self.spec = spec
        dt, t, nb = spec.compute_dtype, spec.pred_len, spec.n_bottleneck
        ub = spec.use_bias
        conv, conv_t = _convs(seq_group)
        self.frames = _local_frames(spec, seq_group)
        lrelu = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        enc: dict[str, nn.Module] = {}
        cin = spec.nc
        widths = _enc_widths(spec.nef, spec.levels)
        for i, w in enumerate(widths):
            enc[f"conv{i}"] = conv(cin, w, dtype=dt, bias=ub)
            if i > 0:
                enc[f"bn{i}"] = BatchNorm(w)
            enc[f"lrelu{i}"] = lrelu()
            cin = w
        enc[f"conv{len(widths)}"] = Conv3d(cin, nb, (t, 4, 4), 1, 0, dt, ub)
        self.enc = Sequential(enc)
        self.bott_bn = BatchNorm(nb)
        self.bott_act = lrelu()
        ngf = spec.ngf
        dec_widths = [ngf * min(2 ** i, 8)
                      for i in range(spec.levels - 1)][::-1]
        first = dec_widths[0] if dec_widths else ngf
        dec: dict[str, nn.Module] = {
            "up0": ConvTranspose3d(nb, first, (t, 4, 4), 1, 0, dt, ub),
            "bn0": BatchNorm(first), "relu0": nn.ReLU()}
        cin = first
        for i, w in enumerate(dec_widths[1:] + [ngf]):
            dec[f"up{i + 1}"] = conv_t(cin, w, dtype=dt, bias=ub)
            dec[f"bn{i + 1}"] = BatchNorm(w)
            dec[f"relu{i + 1}"] = nn.ReLU()
            cin = w
        dec[f"up{spec.levels}"] = conv_t(cin, spec.nc, dtype=dt, bias=ub)
        dec["tanh"] = nn.Tanh()
        self.dec = Sequential(dec)

    def forward(self, x: torch.Tensor, update_stats: bool = True):
        """x: (B,T,S,S,nc) in [-1,1] -> (B,T,S,S,nc) in the compute dtype,
        contiguous.  In train mode BN uses batch statistics and, when
        ``update_stats``, updates the running ones."""
        h = self.enc(_clip_in(self.spec, x, self.frames), update_stats)
        h = self.bott_act(self.bott_bn(h, update_stats))
        # The (B,nb,1,1,1) bottleneck's strides read as NCDHW: the decoder
        # would run NCDHW and its output, permuted back, would not be
        # contiguous (B,T,H,W,C).  The same memory with channels_last_3d
        # strides keeps the decoder channels-last.
        h = h.reshape(h.shape[0], 1, 1, 1, h.shape[1]).permute(0, 4, 1, 2, 3)
        return self.dec(h, update_stats).permute(0, 2, 3, 4, 1)


class Discriminator3D(Sequential):
    """3-D patch discriminator, (B,T,S,S,nc) -> (B,) logits: a BN-free
    two-conv head like the 128-in 2-D D (train_vid_weighted.lua:216-227),
    ``levels - 2`` conv+BN stages down to 4x4, a (T,4,4) valid conv.
    ``seq_group``: as ``Generator3D``'s."""

    def __init__(self, spec: Video3DSpec, seq_group=None):
        dt, ndf, ub = spec.compute_dtype, spec.ndf, spec.use_bias
        conv, _ = _convs(seq_group)
        frames = _local_frames(spec, seq_group)
        lrelu = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        layers: dict[str, nn.Module] = {
            "conv0": conv(spec.nc, ndf // 2, dtype=dt, bias=ub),
            "lrelu0": lrelu(),
            "conv1": conv(ndf // 2, ndf, dtype=dt, bias=ub),
            "lrelu1": lrelu()}
        cin = ndf
        for i in range(2, spec.levels):
            w = ndf * min(2 ** (i - 1), 8)
            layers[f"conv{i}"] = conv(cin, w, dtype=dt, bias=ub)
            layers[f"bn{i}"] = BatchNorm(w)
            layers[f"lrelu{i}"] = lrelu()
            cin = w
        layers[f"conv{spec.levels}"] = Conv3d(cin, 1, (spec.pred_len, 4, 4),
                                              1, 0, dt, ub)
        super().__init__(layers)
        self.spec = spec
        self.frames = frames

    def forward(self, x: torch.Tensor, update_stats: bool = True):
        y = super().forward(_clip_in(self.spec, x, self.frames), update_stats)
        return y.reshape(y.shape[0])
