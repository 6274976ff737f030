"""Video clip eval (test_vid.lua:81-147; counterpart of
video_filler_tpu/eval/video.py): sample one masked clip batch, run G, write
per-frame PNGs and animated GIFs (an in-process writer in place of the
reference's ImageMagick ``convert``, test_vid.lua:145-147).

CLI:
    python -m video_filler_tpu_torch.eval.video device=cuda DATA_ROOT=... \\
        maskName=... net=checkpoints/<name>_<epoch>_state.npz predLen=4 \\
        [regime=video3d]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from video_filler_tpu_torch.config import Opt, from_args, resolve_device
from video_filler_tpu_torch.data.index import VideoCorpus
from video_filler_tpu_torch.data.pipeline import load_mask, video_sampler
from video_filler_tpu_torch.eval.common import gen_input, load_generator
from video_filler_tpu_torch.ops import masks
from video_filler_tpu_torch.train.step import make_preprocess
from video_filler_tpu_torch.utils import save_gif, save_png


def unfold_frames(clip: np.ndarray, nc: int) -> np.ndarray:
    """Channel-folded clips (B,H,W,nc*T) or temporal ones (B,T,H,W,nc) as a
    frame sequence (B*T,H,W,nc)."""
    if clip.ndim == 5:
        return clip.reshape((-1,) + clip.shape[2:])
    b, h, w, c = clip.shape
    return clip.reshape(b, h, w, c // nc, nc).transpose(
        0, 3, 1, 2, 4).reshape(-1, h, w, nc)


def run_test_vid(opt: Opt, out_dir: str | None = None,
                 regime: str = "video", draws: dict | None = None,
                 noise: torch.Tensor | None = None) -> dict[str, np.ndarray]:
    """The channel-folded 2-D regime or the temporal 3-D one.  The
    preprocess's random decisions come from
    ``torch.Generator().manual_seed(manualSeed)``, or from ``draws`` (the
    video preprocess's decision dict, train/step.py ``video_draws``).  A
    noiseGen G takes ``noise`` when given, else z drawn from
    ``manualSeed`` (eval/common.gen_input)."""
    if regime not in ("video", "video3d"):
        raise SystemExit(f"eval.video handles regime=video|video3d, got "
                         f"{regime!r}")
    device = resolve_device(opt)
    gen = load_generator(opt, regime, opt.net)
    rs = np.random.RandomState(opt.manualSeed or None)
    corpus = VideoCorpus(opt.DATA_ROOT,
                         variants=(("gt", 1.0 - opt.gt1Prob),
                                   ("gt1", opt.gt1Prob)))
    mask = load_mask(opt.maskName) if opt.maskName else None
    host_batch = video_sampler(opt, corpus, mask)(rs)
    with torch.inference_mode():
        batch = make_preprocess(opt, regime)(
            {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()},
            torch.Generator().manual_seed(opt.manualSeed), draws=draws)
        ctx = masks.apply_logo_mask(batch["real"], batch["mask"],
                                    opt.maskValue)
        fake = gen(gen_input(opt, ctx, noise=noise))
        inpainted = masks.fill_in(batch["real"], batch["mask"], fake)
    frames = {k: unfold_frames(v.float().cpu().numpy(), opt.nc) for k, v in
              (("fake", fake), ("ctx", ctx), ("inpainted", inpainted))}

    out_dir = out_dir or opt.name
    os.makedirs(out_dir, exist_ok=True)
    for i, (f, c, n) in enumerate(zip(frames["fake"], frames["ctx"],
                                      frames["inpainted"])):
        save_png(f"{out_dir}/pred_{i + 1}.png", f)
        save_png(f"{out_dir}/masked_{i + 1}.png", c)
        save_png(f"{out_dir}/inpaint_{i + 1}.png", n)
    save_gif(f"{out_dir}_result.gif", frames["fake"])
    save_gif(f"{out_dir}_inpaint.gif", frames["inpainted"])
    return frames


if __name__ == "__main__":
    from video_filler_tpu_torch.config import split_regime

    _regime, _rest = split_regime(sys.argv[1:], default="video")
    run_test_vid(from_args(_rest), regime=_regime)
