"""Sequence (temporal) parallelism for the video3d family -- halo exchange
(counterpart of video_filler_tpu/parallel/temporal.py).

Each rank of the ``seq`` axis holds a contiguous chunk of a clip's frames;
the temporal-kernel-3 convs exchange one-frame halos with their seq
neighbours instead of holding the whole clip anywhere:

* ``HaloExchange``: the left neighbour's last frame and the right
  neighbour's first frame around the local chunk, zeros at the clip's ends
  (which is the conv's temporal zero padding).  Its backward sends each
  halo's gradient back and adds it onto the boundary frame it came from.
* ``SPConv3d`` / ``SPConvTranspose3d``: ``Conv3d`` / ``ConvTranspose3d``
  of temporal kernel 3, stride 1, pad 1 on a halo-extended chunk; same
  parameter names and init.  The transposed conv is the same
  ``conv_transpose3d`` with temporal padding 2 over the extended chunk:
  the reversed-kernel correlation over one halo frame per side.
* the T-collapsing bottleneck gathers T (a T x 4 x 4 activation) and its
  nB channels are split over ``seq`` (TP in the middle); ``up0`` comes out
  as a reduce_scatter over T; D's head gathers T (parallel/mesh.py
  ``parallelize``).  BatchNorm statistics of the temporal layers reduce
  over data x seq, ``bott_bn``'s over data.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from video_filler_tpu_torch.ops.layers3d import Conv3d, ConvTranspose3d
from video_filler_tpu_torch.parallel import comm
from video_filler_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    Coords,
    _build,
    coords,
    mesh_shape,
)

CL3D = torch.channels_last_3d


def make_seq_mesh(n_data: int, n_seq: int):
    """A ('data','seq') DeviceMesh over the world for the SP step."""
    if n_data < 1 or n_seq < 1:
        raise ValueError(f"mesh axes must be >=1, got {n_data}x{n_seq}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh_shape(n_data, n_seq, world, SEQ_AXIS)
    return _build((n_data, n_seq), (DATA_AXIS, SEQ_AXIS))


def _neighbours(group) -> tuple[int | None, int | None]:
    """Global ranks of the seq neighbours (None at the clip's ends)."""
    ranks = dist.get_process_group_ranks(group)
    i = ranks.index(dist.get_rank())
    return (ranks[i - 1] if i > 0 else None,
            ranks[i + 1] if i + 1 < len(ranks) else None)


def _exchange(first: torch.Tensor, last: torch.Tensor, group):
    """Send ``last`` right and ``first`` left; receive the left
    neighbour's ``last`` and the right one's ``first`` (zeros without a
    neighbour)."""
    left, right = _neighbours(group)
    from_left = torch.zeros_like(last)
    from_right = torch.zeros_like(first)
    sends, recvs = [], []
    if right is not None:
        sends.append((last, right))
        recvs.append((from_right, right))
    if left is not None:
        sends.append((first, left))
        recvs.append((from_left, left))
    comm.send_recv(sends, recvs, group)
    return from_left, from_right


class HaloExchange(torch.autograd.Function):
    """(B,C,T,H,W) chunk -> (B,C,T+2,H,W): [left halo, chunk, right halo]
    along T."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        first = x[:, :, :1].contiguous()
        last = x[:, :, -1:].contiguous()
        left, right = _exchange(first, last, group)
        return torch.cat([left, x, right], dim=2).contiguous(
            memory_format=CL3D)

    @staticmethod
    def backward(ctx, g):
        # The left halo's gradient belongs to the left neighbour's last
        # frame, the right halo's to the right neighbour's first frame.
        g_left = g[:, :, :1].contiguous()
        g_right = g[:, :, -1:].contiguous()
        # send g_left to the left, g_right to the right; receive the
        # gradient of my first frame from the left neighbour (its right
        # halo) and of my last frame from the right neighbour
        from_left, from_right = _exchange(g_left, g_right, ctx.group)
        gx = g[:, :, 1:-1].clone()
        gx[:, :, :1] += from_left
        gx[:, :, -1:] += from_right
        return gx, None


def halo_exchange(x: torch.Tensor, group) -> torch.Tensor:
    return HaloExchange.apply(x, group)


def _check_temporal(kernel, stride, padding) -> None:
    if (kernel[0], stride[0], padding[0]) != (3, 1, 1):
        raise ValueError("sequence-parallel convs support temporal kernel 3 "
                         f"/ stride 1 / pad 1, got kernel {kernel}, stride "
                         f"{stride}, padding {padding}")


class SPConv3d(Conv3d):
    """``Conv3d`` (temporal kernel 3 / stride 1 / pad 1) over a T-sharded
    clip: the halo exchange gives the temporal padding."""

    def __init__(self, *args, group=None, **kw):
        super().__init__(*args, **kw)
        _check_temporal(self.weight.shape[2:], self.stride, self.padding)
        self.group = group

    def conv(self, x):
        xp = halo_exchange(x.to(self.dtype), self.group)
        return F.conv3d(xp, self.weight.to(self.dtype), stride=self.stride,
                        padding=(0,) + tuple(self.padding[1:]))


class SPConvTranspose3d(ConvTranspose3d):
    """``ConvTranspose3d`` (temporal kernel 3 / stride 1 / pad 1) over a
    T-sharded clip: with one halo frame per side, the temporal padding of
    the transposed conv becomes 2 (kernel - 1), i.e. a valid correlation
    with the reversed kernel; T out == T in per shard."""

    def __init__(self, *args, group=None, **kw):
        super().__init__(*args, **kw)
        _check_temporal(self.weight.shape[2:], self.stride, self.padding)
        self.group = group

    def conv(self, x):
        xp = halo_exchange(x.to(self.dtype), self.group)
        return F.conv_transpose3d(xp, self.weight.to(self.dtype),
                                  stride=self.stride,
                                  padding=(2,) + tuple(self.padding[1:]))


def shard_sp_state(state, mesh):
    """The TrainState cut for the SP step: the bottleneck sharded over
    ``seq`` (parallel/mesh.py ``shard_state``), the rest replicated."""
    from video_filler_tpu_torch.parallel.mesh import shard_state
    return shard_state(state, mesh)


def shard_sp_batch(c: Coords | object, batch: dict,
                   n_micro: int = 1) -> dict:
    """This rank's piece of a full step batch: ``real`` (B,T,H,W,C) by data
    rows (``data_rows``, of ``n_micro`` gradAccum microbatches) and seq
    frames, the (B,1,H,W,1) ``mask`` by rows (its broadcast T axis does not
    shard).  ``c``: the mesh or its ``Coords``."""
    from video_filler_tpu_torch.parallel.distributed import data_rows
    c = c if isinstance(c, Coords) else coords(c)
    out = {}
    for k, x in batch.items():
        x = x[data_rows(x.shape[0], c.n_data, c.data_rank,
                        n_micro).to(x.device)]
        if k == "real":
            per = x.shape[1] // c.n_shard
            x = x[:, c.shard_rank * per:(c.shard_rank + 1) * per]
        out[k] = x.contiguous()
    return out


def check_frame_split(channels: int, n_seq: int, nc: int) -> int:
    """Channels per seq shard of a folded clip of ``channels`` = nc*T;
    raises unless the shards split on frame boundaries (n_seq | T)."""
    per_shard, rem = divmod(channels, n_seq)
    if rem or per_shard % nc:
        raise ValueError(
            f"folded channels {channels} over seq axis {n_seq} give "
            f"{channels / n_seq:g} channels per shard -- not a multiple "
            f"of nc={nc}: seqParallel must divide the clip's frame count T "
            f"(= {channels // nc}) so shards split on frame boundaries")
    return per_shard


def shard_sp_host_batch(c: Coords | object, batch: dict, nc: int = 3
                        ) -> dict:
    """This seq rank's frames of a data rank's uint8 video batch: the
    folded channel axis of ``raw`` (B,H,W,nc*T) is T-major (frame t owns
    channels [t*nc, (t+1)*nc)), so each seq rank takes a contiguous
    channel block of whole frames; the mask is shared.  n_seq must divide
    T (``check_frame_split``).  ``c``: the mesh or its ``Coords``."""
    c = c if isinstance(c, Coords) else coords(c)
    raw = batch["raw"]
    per = check_frame_split(raw.shape[-1], c.n_shard, nc)
    out = dict(batch)
    out["raw"] = raw[..., c.shard_rank * per:(c.shard_rank + 1) * per]
    return out
