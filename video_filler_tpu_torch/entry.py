"""Entry point: the flagship generator's forward, ready to call (counterpart
of ``__graft_entry__.entry`` of the JAX package).

    from video_filler_tpu_torch.entry import entry
    fn, args = entry("cuda")
    out = fn(*args)          # (8, 128, 128, 12)
"""

from __future__ import annotations

import torch

from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.models import build_generator, specs_for_regime


def entry(device: str = "cuda"):
    """(fn, example_args): the 128-out video-inpainting generator
    (train_vid_weighted regime, predLen=4 channel-folded clips, nBottleneck
    4000, bf16 compute) in eval mode with its weights frozen, and a batch of
    8 clips, on ``device``; weights from a fixed seed."""
    opt = Opt(predLen=4, nBottleneck=4000, batchSize=8, device=device)
    dev = resolve_device(opt)
    gspec, _ = specs_for_regime(opt, "video")
    gen = build_generator(gspec, torch.Generator().manual_seed(0))
    gen = gen.to(dev).eval().requires_grad_(False)
    x = torch.zeros((opt.batchSize, 128, 128, opt.nc_total),
                    dtype=torch.float32, device=dev)
    return gen, (x,)
