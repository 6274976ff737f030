"""The port's collectives: thin wrappers over ``torch.distributed`` and the
autograd functions built from them.

Each rank runs its own piece of the step, so every collective's backward
is chosen here, and each is the exact adjoint of its forward:

    all_reduce (sum)  <->  all_reduce (sum)
    all_gather        <->  reduce_scatter (sum)
    reduce_scatter    <->  all_gather

(the halo exchange of parallel/temporal.py is the fourth pair).  With
every loss a rank computes scaled by ``1 / world`` (its share of the
global loss), the backward of each rank then holds its copy's part of the
global gradient, and summing a parameter's gradient over the ranks that
hold it completes it (train/step.py).

Backends: NCCL for CUDA tensors, gloo for CPU tensors, and gloo with CUDA
tensors for two ranks sharing one card (NCCL refuses two ranks on one
device: "Duplicate GPU detected", parallel/probe.py).  Gloo runs
all_reduce, broadcast, all_gather and reduce_scatter on CUDA tensors
itself, but its point-to-point send/recv of a CUDA tensor kills the rank
(gloo::IoException, parallel/probe.py on an H100 with torch 2.11), so
``send_recv`` alone copies CUDA tensors through pinned host buffers under
gloo and counts each such call in ``HOST_STAGED``.  No compute moves to
the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# send_recv calls staged through host buffers, since the process started.
HOST_STAGED = {"send_recv": 0}


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (contiguous)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` on every rank of ``group``, in place."""
    dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The sum over ``group`` of ``t``, split along ``dim`` into equal
    blocks; this rank's block."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[0]} "
                         f"does not split over {n} ranks")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def send_recv(sends: list[tuple[torch.Tensor, int]],
              recvs: list[tuple[torch.Tensor, int]], group=None) -> None:
    """Point-to-point exchange in one batch: each ``(tensor, peer)`` of
    ``sends`` goes to the global rank ``peer``; each buffer of ``recvs`` is
    filled from its peer, in place.  Under gloo, CUDA tensors go through
    pinned host buffers."""
    if not sends and not recvs:
        return
    staged = (sends or recvs)[0][0].is_cuda and \
        dist.get_backend(group) == "gloo"
    if staged:
        HOST_STAGED["send_recv"] += 1
    ops, back = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, _host(t) if staged
                              else t.contiguous(), peer, group))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) \
            if staged else t
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        back.append((t, buf))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        for t, buf in back:
            t.copy_(buf)


def gather_uneven(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order, where the
    sizes along ``dim`` may differ (the noiseGen bottleneck shard of the
    last model rank is wider): the sizes are gathered first, each piece
    padded to the largest and trimmed after the gather."""
    n = dist.get_world_size(group)
    size = torch.tensor([t.shape[dim]], dtype=torch.int64, device=t.device)
    sizes = [int(s) for s in all_gather(size, group)]
    pad = max(sizes) - t.shape[dim]
    x = t
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        x = torch.cat([t, t.new_zeros(shape)], dim)
    full = all_gather(x, group, dim)
    m = max(sizes)
    return torch.cat([full.narrow(dim, r * m, sizes[r]) for r in range(n)],
                     dim)


class AllReduceSum(torch.autograd.Function):
    """y = sum over ``group`` of x; its adjoint is the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class AllGather(torch.autograd.Function):
    """Concatenate the ranks' x along ``dim``; adjoint: reduce_scatter."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class ReduceScatter(torch.autograd.Function):
    """This rank's block along ``dim`` of the sum over ``group``; adjoint:
    all_gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return AllReduceSum.apply(x, group)


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return AllGather.apply(x, group, dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return ReduceScatter.apply(x, group, dim)
