"""Fused weighted MSE: ``sum(w * (pred - target)**2) / pred.numel()``.

Replaces the Pallas TPU kernels ``_fwd_kernel`` / ``_bwd_kernel`` and the
``custom_vjp`` wrapper ``fused_weighted_mse`` of
``video_filler_tpu/ops/pallas/fused_loss.py`` with hand-written CUDA kernels
for Hopper (``csrc/fused_loss.cu``) behind a ``torch.autograd.Function``.

The op is bound by device-memory bandwidth: each direction reads pred,
target and the weights once (the weights are small and broadcast, so they
stay in cache) and the backward writes one gradient.  The kernels take any
4-D (B,H,W,C) shape, with no tiling gate, and read every operand through its
strides: the center target, a strided crop of the real batch, is passed as
the view it is, and broadcast weights keep their zero strides.  The forward
reduces in two fixed-order stages, so repeated calls are bit-identical.

Semantics match ``video_filler_tpu.ops.losses.weighted_mse``: f32
accumulation, gradient with respect to ``pred`` only (target and weights are
data), gradient returned in ``pred``'s dtype.

Dispatch is by device and never falls back: a CPU tensor takes the plain
PyTorch version below; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from video_filler_tpu_torch.ops.cuda import build

# Kernel launches by direction; the main path's run is checked against them.
LAUNCHES = {"fwd": 0, "bwd": 0}

_THREADS = 256          # kThreads in fused_loss.cu
_FWD_BLOCKS_PER_SM = 4  # stage-1 grid: fixed per (N, device), so the sum
_BWD_BLOCKS_PER_SM = 16  # order (and result) is too
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
    if pred.dim() != 4:
        raise ValueError(f"pred must be 4-D (B,H,W,C), got {tuple(pred.shape)}")
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
        ok = (weights.dim() <= 4 and torch.broadcast_shapes(
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


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load csrc/fused_loss.cu; declare its C API."""
    lib = build.load_library("fused_loss")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.vf_wmse_fwd.argtypes = [vp, i32, vp, vp, vp, i64, vp, i32, vp, i32,
                                vp]
    lib.vf_wmse_fwd.restype = i32
    lib.vf_wmse_bwd.argtypes = [vp, i32, vp, vp, vp, i64, vp, vp, i32, i32,
                                vp]
    lib.vf_wmse_bwd.restype = i32
    lib.vf_cuda_error_string.argtypes = [i32]
    lib.vf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _geometry(pred, target, weights):
    """(weights expanded to pred's shape, ctypes int64[16] of sizes and the
    three operands' strides in elements).  Expanding a broadcast tensor only
    sets zero strides; nothing is copied."""
    w = weights.expand(pred.shape)
    meta = (ctypes.c_int64 * 16)(*pred.shape, *pred.stride(),
                                 *target.stride(), *w.stride())
    return w, meta


def _n_blocks(pred: torch.Tensor, per_sm: int) -> int:
    sms = torch.cuda.get_device_properties(pred.device).multi_processor_count
    return max(1, min(-(-pred.numel() // _THREADS), sms * per_sm))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().vf_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_loss {what} kernel failed: CUDA error "
                           f"{err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_forward(pred: torch.Tensor, target: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Run the forward kernel; returns a 0-dim f32 tensor on pred's device."""
    lib = _lib()
    w, meta = _geometry(pred, target, weights)
    n_blocks = _n_blocks(pred, _FWD_BLOCKS_PER_SM)
    partials = torch.empty(n_blocks, dtype=torch.float32, device=pred.device)
    out = torch.empty((), dtype=torch.float32, device=pred.device)
    err = lib.vf_wmse_fwd(pred.data_ptr(), int(pred.dtype == torch.bfloat16),
                          target.data_ptr(), w.data_ptr(), meta,
                          pred.numel(), partials.data_ptr(), n_blocks,
                          out.data_ptr(), pred.device.index or 0,
                          _stream(pred))
    _raise_on(err, "forward")
    LAUNCHES["fwd"] += 1
    return out


def launch_backward(pred: torch.Tensor, target: torch.Tensor,
                    weights: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """Run the backward kernel; returns a contiguous gradient of pred's shape
    and dtype.  ``gbar`` (the upstream scalar) stays on the device."""
    lib = _lib()
    w, meta = _geometry(pred, target, weights)
    gbar = gbar.to(device=pred.device, dtype=torch.float32).contiguous()
    grad = torch.empty(pred.shape, dtype=pred.dtype, device=pred.device)
    n_blocks = _n_blocks(pred, _BWD_BLOCKS_PER_SM)
    err = lib.vf_wmse_bwd(pred.data_ptr(), int(pred.dtype == torch.bfloat16),
                          target.data_ptr(), w.data_ptr(), meta,
                          pred.numel(), gbar.data_ptr(), grad.data_ptr(),
                          n_blocks, pred.device.index or 0, _stream(pred))
    _raise_on(err, "backward")
    LAUNCHES["bwd"] += 1
    return grad


class _FusedWeightedMSE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pred, target, weights):
        ctx.save_for_backward(pred, target, weights)
        if pred.is_cuda:
            return launch_forward(pred, target, weights)
        return weighted_mse_reference(pred, target, weights)

    @staticmethod
    def backward(ctx, gbar):
        pred, target, weights = ctx.saved_tensors
        if pred.is_cuda:
            grad = launch_backward(pred, target, weights, gbar)
        else:
            grad = weighted_mse_grad_reference(pred, target, weights, gbar)
        return grad, None, None


def fused_weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """``sum(weights * (pred - target)**2) / pred.numel()`` as a 0-dim f32
    tensor, differentiable with respect to ``pred``.

    pred: (B,H,W,C) float32 or bfloat16, any strides.  target: float32 of
    pred's shape, any strides.  weights: float32, broadcastable to pred's
    shape (e.g. (1,H,W,1) or a scalar tensor)."""
    _validate(pred, target, weights)
    return _FusedWeightedMSE.apply(pred, target, weights)
