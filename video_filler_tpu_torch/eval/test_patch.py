"""Patch / near-full-image eval (test.lua:72-130; counterpart of
video_filler_tpu/eval/test_patch.py): sample a batch through the center
sampler, mean-fill the hole, forward, paste back, save grids.  The
reference's two modes are chosen by loadSize (350: random-crop patches,
129: near-full images), which flows through the sampler.

CLI:
    python -m video_filler_tpu_torch.eval.test_patch device=cuda \\
        DATA_ROOT=... net=checkpoints/<name>_<epoch>_state.npz [name=out]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from video_filler_tpu_torch.config import Opt, from_args, resolve_device
from video_filler_tpu_torch.data.index import FolderIndex
from video_filler_tpu_torch.data.pipeline import center_sampler
from video_filler_tpu_torch.eval.common import gen_input, load_generator
from video_filler_tpu_torch.ops import masks
from video_filler_tpu_torch.ops.image import normalize_uint8
from video_filler_tpu_torch.utils import save_image_grid


def run_test(opt: Opt, out_prefix: str | None = None
             ) -> dict[str, np.ndarray]:
    """Writes <prefix>_{real,ctx,inpainted}.png; returns those arrays."""
    gen = load_generator(opt, "center", opt.net)
    rs = np.random.RandomState(opt.manualSeed or None)
    batch = center_sampler(opt, FolderIndex(opt.DATA_ROOT))(rs)
    with torch.inference_mode():
        real = normalize_uint8(
            torch.from_numpy(batch["raw"]).to(resolve_device(opt)))
        ctx = masks.center_mask_fill(real, opt.overlapPred)
        pred = gen(gen_input(opt, ctx))
        inpainted = masks.paste_center(ctx, pred, opt.overlapPred)
    out = {k: v.cpu().numpy() for k, v in
           (("real", real), ("ctx", ctx), ("inpainted", inpainted))}
    prefix = out_prefix or opt.name
    for k, v in out.items():
        save_image_grid(f"{prefix}_{k}.png", v)
    return out


if __name__ == "__main__":
    run_test(from_args(sys.argv[1:]))
