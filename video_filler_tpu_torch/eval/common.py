"""Shared eval plumbing: checkpoint -> eval-mode generator on the device
(counterpart of video_filler_tpu/eval/common.py)."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from video_filler_tpu_torch.checkpoint import restore_subtree
from video_filler_tpu_torch.checkpoint.convert import tree_to_state_dict
from video_filler_tpu_torch.checkpoint.t7 import import_generator
from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.models import (
    Video3DSpec,
    build_generator,
    specs_for_regime,
)
from video_filler_tpu_torch.ops.layers import ConvBase
from video_filler_tpu_torch.train.step import draw_noise


def generator_spec(opt: Opt, regime: str):
    """The regime's generator spec (a ``Video3DSpec`` for video3d); an
    option the regime refuses (noiseGen on video3d) exits naming it."""
    try:
        return specs_for_regime(opt, regime)[0]
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from None


def gen_input(opt: Opt, ctx: torch.Tensor, gen: torch.Generator | None = None,
              noise: torch.Tensor | None = None):
    """Generator input for an eval forward: the context, or for a noiseGen
    G (ctx, z) with z (B,1,1,nz) -- ``noise`` when given (the JAX side's
    draw in a test), else drawn from ``gen`` (default: seeded with
    ``manualSeed``, as the JAX CLIs key theirs) by ``noisetype``, as the
    train step draws it (video_filler_tpu/eval/common.py:12-27)."""
    if not opt.noiseGen:
        return ctx
    if noise is None:
        gen = gen if gen is not None else \
            torch.Generator().manual_seed(opt.manualSeed)
        noise = draw_noise(opt, gen, ctx.shape[0], ctx.device)
    return ctx, noise.to(ctx.device)


def load_generator(opt: Opt, regime: str, net_path: str,
                   device: torch.device | str | None = None) -> nn.Module:
    """Just the generator of a training checkpoint (either package's file,
    a full state or a keepBest ``_best_`` file), or of a reference Torch7
    netG ``.t7`` (checkpoint/t7.py ``import_generator``, then the
    converter's leaf mapping), in eval mode -- BN reads
    its running statistics, as ``net:evaluate()`` in every reference test
    script -- on ``device`` (default ``opt.device``), frozen.  D and the
    optimizer states in the file are ignored.

    Weight residency: each conv weight and bias, 2-D or 3-D, is cast to
    the compute dtype once here, as the JAX loader casts ``w`` and ``b``;
    the conv layers cast to it on every call anyway, so the numbers are the
    same and the per-call cast becomes a no-op.  BN leaves stay f32."""
    device = resolve_device(opt) if device is None else torch.device(device)
    spec = generator_spec(opt, regime)
    gen = build_generator(spec, torch.Generator().manual_seed(0))
    if net_path.endswith(".t7"):
        _load_t7(gen, spec, net_path, regime)
    else:
        restore_subtree(net_path, gen, ".params_g", ".state_g")
    gen = gen.to(device).eval().requires_grad_(False)
    for m in gen.modules():
        if isinstance(m, ConvBase):
            m.weight.data = m.weight.data.to(m.dtype)
            if m.bias is not None:
                m.bias.data = m.bias.data.to(m.dtype)
    return gen


def _load_t7(gen: nn.Module, spec, net_path: str, regime: str) -> None:
    """A reference netG .t7 into ``gen`` (video_filler_tpu/eval/common.py:
    41-50).  Torch7 nets are the plain 2-D topology: video3d, noiseGen and
    useBias generators have layers such a file does not hold."""
    if isinstance(spec, Video3DSpec):
        raise SystemExit(
            f"net={net_path}: a Torch7 .t7 net is a 2-D generator; "
            f"regime={regime} (the temporal 3-D family) has no Torch7 form "
            "-- load its .npz checkpoint")
    sd = tree_to_state_dict(*import_generator(net_path, spec))
    missing = sorted(set(gen.state_dict()) - set(sd))
    if missing:
        raise SystemExit(
            f"net={net_path}: the Torch7 net has no {missing[:4]} -- it "
            "holds the reference's plain netG (no noiseGen join, no conv "
            "biases); match the options to it")
    gen.load_state_dict(sd)


@contextlib.contextmanager
def live_generator(opt: Opt, regime: str, state):
    """The training state's generator scored in place, no checkpoint file:
    in eval mode under ``torch.inference_mode`` for the ``with`` block (no
    cast of the training weights, no update of the running statistics),
    back in its earlier mode afterwards."""
    generator_spec(opt, regime)
    gen = state.gen
    was_training = gen.training
    gen.eval()
    try:
        with torch.inference_mode():
            yield gen
    finally:
        gen.train(was_training)
