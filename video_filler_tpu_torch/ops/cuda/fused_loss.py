"""Fused weighted MSE: ``sum(w * (pred - target)**2) / pred.numel()``.

Replaces the Pallas TPU kernels ``_fwd_kernel`` / ``_bwd_kernel`` and the
``custom_vjp`` wrapper ``fused_weighted_mse`` of
``video_filler_tpu/ops/pallas/fused_loss.py`` with hand-written CUDA kernels
for Hopper (``csrc/fused_loss.cu``) behind a ``torch.autograd.Function``.

The op is bound by device-memory bytes (``kernel_bytes``): each direction
reads pred, target and the weights once, and the backward writes one
gradient.  The operands are 4-D images (B,H,W,C) or 5-D clips (B,T,H,W,C).
``plan`` decides, on the host, how the kernels walk them: the vectorised
32-bit row path (16-byte loads, no per-element division) where the operands
allow it, which every geometry of the train step does, and else the generic
strided path.  The weights keep their broadcast (zero) strides -- the
(B,1,H,W,1) clip mask over T included -- and the center target stays a
strided crop; nothing is copied.  The forward is one launch that sums in a
fixed order, so repeated calls are bit-identical.

Semantics match ``video_filler_tpu.ops.losses.weighted_mse``: f32
accumulation, gradient with respect to ``pred`` only (target and weights are
data), gradient returned in ``pred``'s dtype.

Dispatch is by device and never falls back: a CPU tensor takes the plain
PyTorch version below; a CUDA tensor launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from video_filler_tpu_torch.ops.cuda import build

# Kernel launches by direction, and by the path the plan chose (either
# direction); the main path's run is checked against both.
LAUNCHES = {"fwd": 0, "bwd": 0}
VARIANT_LAUNCHES = {"row": 0, "generic": 0}

_THREADS = 256            # kThreads in fused_loss.cu
_META_LEN = 31            # kMetaLen in fused_loss.cu
_INT32_MAX = 2 ** 31 - 1
_PRED_DTYPES = (torch.float32, torch.bfloat16)


def weighted_mse_reference(pred: torch.Tensor, target: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 ``sum(w*(pred-target)**2) / numel``."""
    err = (pred.float() - target.float()).square() * weights
    return err.sum() / pred.numel()


def weighted_mse_grad_reference(pred: torch.Tensor, target: torch.Tensor,
                                weights: torch.Tensor,
                                gbar: torch.Tensor) -> torch.Tensor:
    """Analytic gradient of the plain version with respect to ``pred``:
    ``(pred - target) * w * (gbar * 2/N)`` in f32, cast to pred's dtype."""
    scale = gbar.float() * (2.0 / pred.numel())
    grad = (pred.float() - target.float()) * weights * scale
    return grad.to(pred.dtype)


def _validate(pred: torch.Tensor, target: torch.Tensor,
              weights: torch.Tensor) -> None:
    if pred.dim() not in (4, 5):
        raise ValueError(f"pred must be 4-D (B,H,W,C) or 5-D (B,T,H,W,C), "
                         f"got {tuple(pred.shape)}")
    if pred.numel() == 0:
        raise ValueError("pred is empty")
    if pred.dtype not in _PRED_DTYPES:
        raise TypeError(f"pred must be float32 or bfloat16, got {pred.dtype}")
    if target.shape != pred.shape:
        raise ValueError(f"target shape {tuple(target.shape)} != pred shape "
                         f"{tuple(pred.shape)}")
    if target.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"target and weights must be float32, got "
                        f"{target.dtype} and {weights.dtype}")
    try:
        ok = (weights.dim() <= pred.dim() and torch.broadcast_shapes(
            weights.shape, pred.shape) == pred.shape)
    except RuntimeError:  # incompatible sizes
        ok = False
    if not ok:
        raise ValueError(f"weights shape {tuple(weights.shape)} does not "
                         f"broadcast to {tuple(pred.shape)}")
    devices = {pred.device, target.device, weights.device}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pred.device}")


def _stored_elements(t: torch.Tensor) -> int:
    """Elements ``t`` holds in memory: its broadcast (stride 0) dims count
    once."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)


def kernel_bytes(pred: torch.Tensor, target: torch.Tensor,
                 weights: torch.Tensor, direction: str) -> int:
    """Least device-memory traffic of one call: pred and target read once,
    the weights once at their stored size, the backward's gradient (pred's
    dtype) written once.  The 4-byte scalars (the loss, the upstream
    gradient) are left out."""
    n = pred.numel()
    total = (n * pred.element_size() + n * target.element_size()
             + _stored_elements(weights) * weights.element_size())
    if direction == "bwd":
        total += n * pred.element_size()
    elif direction != "fwd":
        raise ValueError(f"direction must be 'fwd' or 'bwd', not "
                         f"{direction!r}")
    return total


def fast_div(d: int) -> tuple[int, int]:
    """(multiplier, shift) with ``n // d == (((n * mul) >> 32) + n) >> shift``
    for every 0 <= n < 2**31, the sum kept in 32 bits (the round-up method
    of Granlund and Montgomery)."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} out of range")
    shift = (d - 1).bit_length()
    return (2 ** 32 * (2 ** shift - d)) // d + 1, shift


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernels walk one set of operands.

    ``shape`` is (b, t, y, x, c): three outer dims, then a row of L = x*c
    elements; R = b*t*y rows.  A 4-D (B,H,W,C) operand set has T = 1.  The
    outer dims are merged where all three operands allow it (``_merge``) and
    padded in front with size-1 dims, so a row splits into (b, t, y) by at
    most two divisions.  Strides are in elements, the weights' after
    broadcasting to pred's shape (0 on a broadcast dim); a dim of size 1
    gets stride 0.  ``variant`` "row": pred and target are contiguous within
    a row, every base and outer stride 16-byte aligned, L a multiple of
    ``vec`` (pred elements per 16 bytes) and every offset fits in int32;
    ``weights_vec``: the weights are too, and load as float4.  Else
    "generic"; ``reason`` says why."""
    variant: str
    index32: bool
    shape: tuple[int, int, int, int, int]
    pred_strides: tuple[int, int, int, int, int]
    target_strides: tuple[int, int, int, int, int]
    weight_strides: tuple[int, int, int, int, int]
    vec: int
    weights_vec: bool
    reason: str = ""

    @property
    def row_len(self) -> int:
        return self.shape[3] * self.shape[4]

    @functools.cached_property
    def meta(self) -> tuple[int, ...]:
        """The int64 values csrc/fused_loss.cu reads (its enum Meta)."""
        divs = (0,) * 8
        if self.variant == "row":
            divs = (*fast_div(self.row_len // self.vec),
                    *fast_div(self.shape[2]), *fast_div(self.shape[1]),
                    *fast_div(self.shape[4]))
        meta = (*self.shape, *self.pred_strides, *self.target_strides,
                *self.weight_strides, int(self.variant == "generic"),
                int(self.index32), int(self.weights_vec), *divs)
        assert len(meta) == _META_LEN
        return meta


def _strides(t: torch.Tensor) -> tuple[int, ...]:
    return tuple(st if s > 1 else 0 for s, st in zip(t.shape, t.stride()))


def _merge(shape, strides):
    """The outer (b, t, y) dims with each pair merged whose strides merge
    for every operand (outer stride = inner size * inner stride), size-1
    dims dropped, padded in front to three.  ``strides``: one 5-tuple per
    operand.  Returns (shape, strides) of the same form."""
    dims = [(shape[k], tuple(s[k] for s in strides)) for k in range(3)]
    merged = []                                   # innermost first
    for size, st in reversed(dims):
        if size == 1:
            continue
        if merged and all(a == merged[-1][0] * b
                          for a, b in zip(st, merged[-1][1])):
            inner, inner_st = merged.pop()
            merged.append((size * inner, inner_st))
        else:
            merged.append((size, st))
    merged += [(1, (0,) * len(strides))] * (3 - len(merged))
    outer = merged[::-1]
    return (tuple(size for size, _ in outer) + tuple(shape[3:]),
            [tuple(st[i] for _, st in outer) + tuple(s[3:])
             for i, s in enumerate(strides)])


def _row_contiguous(strides, shape) -> bool:
    """Element j of a row (x = j // C, c = j % C) lies at offset j."""
    w, c = shape[3:]
    return strides[3:] == (c if w > 1 else 0, 1 if c > 1 else 0)


def _aligned(t: torch.Tensor, strides) -> bool:
    """16-byte aligned base and outer (b, t, y) strides."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0 for st in strides[:3]))


def plan(pred: torch.Tensor, target: torch.Tensor,
         weights: torch.Tensor) -> Plan:
    """Choose the kernel path for validated operands (see ``Plan``)."""
    shape = tuple(pred.shape)
    w = weights.expand(shape)
    strides = [_strides(t) for t in (pred, target, w)]
    if len(shape) == 4:                           # an image: T = 1
        shape = shape[:1] + (1,) + shape[1:]
        strides = [s[:1] + (0,) + s[1:] for s in strides]
    shape, (ps, ts, ws) = _merge(shape, strides)
    n = pred.numel()
    max_offset = max(sum((s - 1) * st for s, st in zip(shape, sts))
                     for sts in (ps, ts, ws))
    index32 = n <= _INT32_MAX and max_offset <= _INT32_MAX
    vec = 16 // pred.element_size()
    weights_vec = _row_contiguous(ws, shape) and _aligned(w, ws)
    checks = [
        (index32, "an offset needs 64 bits"),
        (_row_contiguous(ps, shape), "pred is not contiguous within a row"),
        (_row_contiguous(ts, shape), "target is not contiguous within a row"),
        (shape[3] * shape[4] % vec == 0, f"the row length is not a multiple "
                                         f"of {vec}"),
        (_aligned(pred, ps) and _aligned(target, ts),
         "a base or outer stride is not 16-byte aligned"),
    ]
    reason = next((why for ok, why in checks if not ok), "")
    return Plan(variant="generic" if reason else "row", index32=index32,
                shape=shape, pred_strides=ps, target_strides=ts,
                weight_strides=ws, vec=vec,
                weights_vec=weights_vec and not reason, reason=reason)


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load csrc/fused_loss.cu; declare its C API."""
    lib = build.load_library("fused_loss")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vf_wmse_meta_len.restype = i32
    if lib.vf_wmse_meta_len() != _META_LEN:
        raise RuntimeError("csrc/fused_loss.cu and this wrapper disagree on "
                           "the meta layout")
    lib.vf_wmse_fwd.argtypes = [vp, i32, vp, vp, vp, vp, i32, vp, i32, vp]
    lib.vf_wmse_fwd.restype = i32
    lib.vf_wmse_bwd.argtypes = [vp, i32, vp, vp, vp, vp, vp, i32, vp]
    lib.vf_wmse_bwd.restype = i32
    lib.vf_cuda_error_string.argtypes = [i32]
    lib.vf_cuda_error_string.restype = ctypes.c_char_p
    return lib


# (device index, stream handle) -> (zeroed workspace, partials capacity).
_WORKSPACES: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}


def _workspace(device: torch.device) -> tuple[torch.Tensor, int]:
    """The forward's partials and ticket for the current stream: allocated
    zeroed at the first call on a (device, stream) and reused, since every
    call leaves the ticket at 0.  Its capacity is the most blocks the device
    can hold at once, which bounds the forward's grid."""
    stream = torch.cuda.current_stream(device)
    key = (device.index or 0, stream.cuda_stream)
    if key not in _WORKSPACES:
        props = torch.cuda.get_device_properties(device)
        capacity = props.multi_processor_count * (
            props.max_threads_per_multi_processor // _THREADS)
        with torch.cuda.stream(stream):
            ws = torch.zeros(capacity + 1, dtype=torch.float32, device=device)
        _WORKSPACES[key] = (ws, capacity)
    return _WORKSPACES[key]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().vf_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_loss {what} kernel failed: CUDA error "
                           f"{err} ({msg})")


def _count(p: Plan, direction: str) -> None:
    LAUNCHES[direction] += 1
    VARIANT_LAUNCHES[p.variant] += 1


def launch_forward(pred: torch.Tensor, target: torch.Tensor,
                   weights: torch.Tensor, p: Plan | None = None
                   ) -> torch.Tensor:
    """Run the forward kernel (one launch); returns a 0-dim f32 tensor on
    pred's device.  ``p``: the operands' plan, made here if not given."""
    lib = _lib()
    w = weights.expand(pred.shape)
    p = p or plan(pred, target, weights)
    ws, capacity = _workspace(pred.device)
    out = torch.empty((), dtype=torch.float32, device=pred.device)
    err = lib.vf_wmse_fwd(pred.data_ptr(), int(pred.dtype == torch.bfloat16),
                          target.data_ptr(), w.data_ptr(),
                          (ctypes.c_int64 * _META_LEN)(*p.meta),
                          ws.data_ptr(), capacity, out.data_ptr(),
                          pred.device.index or 0,
                          torch.cuda.current_stream(pred.device).cuda_stream)
    _raise_on(err, "forward")
    _count(p, "fwd")
    return out


def launch_backward(pred: torch.Tensor, target: torch.Tensor,
                    weights: torch.Tensor, gbar: torch.Tensor,
                    p: Plan | None = None) -> torch.Tensor:
    """Run the backward kernel; returns a contiguous gradient of pred's shape
    and dtype (its row-major order is the plan's row order).  ``gbar`` (the upstream scalar) stays on the device."""
    lib = _lib()
    w = weights.expand(pred.shape)
    p = p or plan(pred, target, weights)
    gbar = gbar.to(device=pred.device, dtype=torch.float32).contiguous()
    grad = torch.empty(pred.shape, dtype=pred.dtype, device=pred.device)
    err = lib.vf_wmse_bwd(pred.data_ptr(), int(pred.dtype == torch.bfloat16),
                          target.data_ptr(), w.data_ptr(),
                          (ctypes.c_int64 * _META_LEN)(*p.meta),
                          gbar.data_ptr(), grad.data_ptr(),
                          pred.device.index or 0,
                          torch.cuda.current_stream(pred.device).cuda_stream)
    _raise_on(err, "backward")
    _count(p, "bwd")
    return grad


class _FusedWeightedMSE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pred, target, weights):
        ctx.save_for_backward(pred, target, weights)
        if pred.is_cuda:
            ctx.plan = plan(pred, target, weights)
            return launch_forward(pred, target, weights, ctx.plan)
        return weighted_mse_reference(pred, target, weights)

    @staticmethod
    def backward(ctx, gbar):
        pred, target, weights = ctx.saved_tensors
        if pred.is_cuda:
            grad = launch_backward(pred, target, weights, gbar, ctx.plan)
        else:
            grad = weighted_mse_grad_reference(pred, target, weights, gbar)
        return grad, None, None


def fused_weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """``sum(weights * (pred - target)**2) / pred.numel()`` as a 0-dim f32
    tensor, differentiable with respect to ``pred``.

    pred: (B,H,W,C) or (B,T,H,W,C), float32 or bfloat16, any strides.
    target: float32 of pred's shape, any strides.  weights: float32,
    broadcastable to pred's shape (e.g. (1,H,W,1), (B,1,H,W,1) or a scalar
    tensor)."""
    _validate(pred, target, weights)
    return _FusedWeightedMSE.apply(pred, target, weights)
