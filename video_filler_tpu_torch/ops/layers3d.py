"""3-D (temporal) conv layers (counterpart of video_filler_tpu/ops/layers3d.py).

Clips are (B,T,H,W,C) at the models' boundary; inside, the layers work on
NCDHW tensors with PyTorch weight layouts in ``torch.channels_last_3d``
memory (the NDHWC bytes), as the 2-D layers run channels-last.  Same
conventions as ops/layers.py: bias-free unless ``bias`` (added after the
conv in the compute dtype), N(0,0.02) init, the input and the weight cast
to the compute dtype before each conv; BatchNorm is the 2-D
layers' (``F.batch_norm`` reduces over every axis but channels).

Layouts against the JAX package: a conv weight DHWIO maps to OIDHW by
``transpose(4,3,0,1,2)``; a transposed-conv weight (kt,kh,kw,cin,cout) maps
to (cin,cout,kt,kh,kw) by ``transpose(3,4,0,1,2)``, with no flip.  One
``F.conv_transpose3d`` equals both JAX paths, the 1x1x1 bottleneck einsum
and the input-dilated conv with the reversed kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_filler_tpu_torch.ops.layers import ConvBase


def _triple(v) -> tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


class Conv3d(ConvBase):
    """3-D cross-correlation; kernel, stride and padding are (T,H,W)
    triples.  Weight (cout, cin, kt, kh, kw)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 4, 4), stride=(1, 2, 2),
                 padding=(1, 1, 1), dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__((cout, cin, *_triple(kernel)), cout, _triple(stride),
                         _triple(padding), dtype, bias)

    def conv(self, x):
        return F.conv3d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class ConvTranspose3d(ConvBase):
    """3-D transposed conv, out = (in-1)*s - 2p + k per axis, the exact
    transpose of ``Conv3d``.  Weight (cin, cout, kt, kh, kw)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 4, 4), stride=(1, 2, 2),
                 padding=(1, 1, 1), dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__((cin, cout, *_triple(kernel)), cout, _triple(stride),
                         _triple(padding), dtype, bias)

    def conv(self, x):
        return F.conv_transpose3d(x.to(self.dtype),
                                  self.weight.to(self.dtype),
                                  stride=self.stride, padding=self.padding)


def fold_time(x: torch.Tensor) -> torch.Tensor:
    """(B,T,H,W,C) -> (B,H,W,T*C), frame-major channels (the reference's 2-D
    representation, datavid/donkey_folder.lua:81-85).  A view where the
    strides allow it."""
    b, t, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def unfold_time(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B,H,W,T*C) -> (B,T,H,W,C), the inverse of ``fold_time``: a strided
    view of ``x``."""
    b, h, w, tc = x.shape
    return x.reshape(b, h, w, frames, tc // frames).permute(0, 3, 1, 2, 4)
