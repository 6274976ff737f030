"""Center-inpainting demo (demo.lua:49-97; counterpart of
video_filler_tpu/eval/demo.py): read images from a folder, scale to 128²,
mean-fill the center hole, run G, paste the predicted center back (keeping
the overlapPred ring), save a side-by-side grid PNG.

CLI:
    python -m video_filler_tpu_torch.eval.demo device=cuda imDir=... \\
        net=checkpoints/<name>_<epoch>_state.npz [overlapPred=4] [name=out]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from video_filler_tpu_torch.config import Opt, from_args, resolve_device
from video_filler_tpu_torch.data import decode
from video_filler_tpu_torch.data.index import IMG_EXTS
from video_filler_tpu_torch.eval.common import gen_input, load_generator
from video_filler_tpu_torch.ops import masks
from video_filler_tpu_torch.ops.image import normalize_uint8
from video_filler_tpu_torch.utils import save_image_grid


def run_demo(opt: Opt, out_path: str | None = None) -> dict[str, np.ndarray]:
    """Writes the grid; returns the arrays (ctx, pred_center, inpainted)."""
    gen = load_generator(opt, "center", opt.net)
    files = sorted(f for f in os.listdir(opt.imDir)
                   if f.lower().endswith(IMG_EXTS))[: opt.batchSize]
    if not files:
        raise FileNotFoundError(f"no images in {opt.imDir}")
    imgs = np.stack([decode.resize(
        decode.decode_image(os.path.join(opt.imDir, f), opt.nc), 128, 128)
        for f in files])
    with torch.inference_mode():
        real = normalize_uint8(torch.from_numpy(imgs).to(resolve_device(opt)))
        ctx = masks.center_mask_fill(real, opt.overlapPred)
        pred_center = gen(gen_input(opt, ctx))
        inpainted = masks.paste_center(ctx, pred_center, opt.overlapPred)
    out = {"ctx": ctx, "pred_center": pred_center.float(),
           "inpainted": inpainted}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    # side by side: masked context | inpainted result (demo.lua:92-97)
    save_image_grid(out_path or f"{opt.name}.png",
                    np.concatenate([out["ctx"], out["inpainted"]], axis=2),
                    n_cols=1)
    return out


if __name__ == "__main__":
    run_demo(from_args(sys.argv[1:]))
