"""Render the logo and wholeim gallery from the ``logo_wholeim`` ledger's
checkpoints (the counterpart of the JAX package's
scripts/render_gallery_lw.py):

- logo: a grid of masked inputs and a grid of the generator's outputs
  (``logo_masked.png``, ``logo_inpaint.png``) on a train batch of 8;
- wholeim: one full frame from the held-out tail of the corpus, through
  the serving path (serve.py ``InpaintServer`` in full-frame mode):
  ``wholeim_serve_{orig,masked,inpaint}.png``.

    python -m video_filler_tpu_torch.scripts.render_gallery_lw WORKDIR \
        OUTDIR [device=cpu] [key=value ...]

WORKDIR is the ledger's work directory (``python -m
video_filler_tpu_torch.ledger logo_wholeim`` writes
``checkpoints/lw_lg_final_999_state.npz`` and
``checkpoints/lw_wi_final_999_state.npz`` there, beside its corpora).
``key=value`` options go over both models' options (the widths of a tiny
run, for one).  Runs on the card unless ``device=cpu``.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch
from PIL import Image

from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.data.index import VideoCorpus
from video_filler_tpu_torch.data.pipeline import make_sampler
from video_filler_tpu_torch.eval.common import load_generator
from video_filler_tpu_torch.ledger.__main__ import parse_overrides
from video_filler_tpu_torch.serve import InpaintServer
from video_filler_tpu_torch.train.step import make_preprocess
from video_filler_tpu_torch.utils.io import save_image_grid, save_png

LOGO_NET = "checkpoints/lw_lg_final_999_state.npz"
WHOLEIM_NET = "checkpoints/lw_wi_final_999_state.npz"


def render_logo(out: str, over: dict) -> None:
    """Masked input grid and the generator's output grid on one train
    batch of 8 (logo has no mask: the output is the whole prediction)."""
    opt = Opt(**{**dict(DATA_ROOT="pairs/masked",
                        DATA_ROOT_GT="pairs/gt_pairs", batchSize=8,
                        loadSize=150, fineSize=128, nBottleneck=4000,
                        manualSeed=222, display=False,
                        computeDtype="float32", net=LOGO_NET), **over})
    device = resolve_device(opt)
    sampler, _ = make_sampler(opt, "logo", split="train")
    preprocess = make_preprocess(opt, "logo")
    gen = load_generator(opt, "logo", opt.net, device)
    host = sampler(np.random.RandomState(222))
    batch = preprocess({k: torch.from_numpy(v).to(device)
                        for k, v in host.items()},
                       torch.Generator().manual_seed(222))
    with torch.inference_mode():
        pred = gen(batch["masked"])
    save_image_grid(f"{out}/logo_masked.png", batch["masked"].cpu().numpy(),
                    n_cols=4)
    save_image_grid(f"{out}/logo_inpaint.png",
                    pred.float().cpu().numpy(), n_cols=4)
    print("logo grids written", flush=True)


def render_wholeim(out: str, over: dict) -> str:
    """The last frame of video 0's held-out tail (split=80) through the
    full-frame wholeim server; returns the frame's path."""
    corpus = VideoCorpus("corpus", split=80)
    last = corpus.starts[0] + corpus.counts[0] - 1
    frame_path = corpus.get_clip(0, last, 1)[0]
    frame = np.asarray(Image.open(frame_path).convert("RGB"), np.uint8)
    mask = np.asarray(Image.open("mask.png").convert("L")) > 128
    mask = mask.astype(np.uint8)[..., None]
    opt = Opt(**{**dict(nef=192, ngf=192, ndf=128, nBottleneck=6400,
                        frameH=frame.shape[0], frameW=frame.shape[1],
                        batchSize=1, computeDtype="float32",
                        display=False), **over})
    srv = InpaintServer(opt, "wholeim", WHOLEIM_NET, port=0,
                        max_delay_ms=1.0)
    try:
        inpainted = srv.infer(frame[None], mask[None])[0]
    finally:
        srv.close()
    save_png(f"{out}/wholeim_serve_orig.png", frame)
    masked = frame.copy()
    masked[mask[..., 0] > 0] = int(round(opt.maskValue * 255.0))
    save_png(f"{out}/wholeim_serve_masked.png", masked)
    save_png(f"{out}/wholeim_serve_inpaint.png", inpainted)
    print("wholeim serve frames written", flush=True)
    return frame_path


def main(argv: list[str]) -> None:
    paths = [a for a in argv if "=" not in a]
    if len(paths) != 2:
        raise SystemExit(__doc__)
    work, out = paths
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    over = parse_overrides([a for a in argv if "=" in a])
    with contextlib.chdir(work):
        render_logo(out, over)
        print("frame:", render_wholeim(out, over), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
