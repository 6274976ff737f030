"""Tiled full-frame video inference, the reference's flagship demo
(test_vid_wholeim.lua:115-257, and test_more_complex.lua without the
initializer); counterpart of video_filler_tpu/eval/wholeim.py.

1. Load predLen consecutive frames, scale to (loadSize, loadSize*W/H),
   mask-fill with the gt(0.3)-binarized scaled mask, normalize, pad
   bottom-right to fineSize multiples (pad value -1 after normalizing: the
   reference normalizes after writing into a zero canvas,
   test_vid_wholeim.lua:139-141).
2. Cut fineSize² tiles; frames are grouped inputLen per sample, so a net
   trained on nc*inputLen channels sees predLen/inputLen samples per tile.
   The three leftmost top-row tiles are flipped vertically before the net
   and back after (eval/tiling.py).
3. Optional initializer cascade (``initName``): a second generator's
   output fills the masked pixels before G (test_vid_wholeim.lua:178-190).
4. The prediction is composited into the frames inside the padded mask
   only, and written as pred_/inpaint_/inpaint_crop_/orig_*.png and three
   GIFs (test_vid_wholeim.lua:207-257).

Every tile of every frame group goes through G in one batched forward.

CLI:
    python -m video_filler_tpu_torch.eval.wholeim device=cuda DATA_ROOT=... \\
        maskName=... net=checkpoints/<name>_<epoch>_state.npz predLen=4 \\
        loadSize=360 [inputLen=2] [initName=...]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from video_filler_tpu_torch.config import Opt, from_args, resolve_device
from video_filler_tpu_torch.data import decode
from video_filler_tpu_torch.data.index import VideoCorpus
from video_filler_tpu_torch.eval.common import load_generator
from video_filler_tpu_torch.eval.tiling import (
    frame_geometry,
    gather_tiles,
    scatter_tiles,
)
from video_filler_tpu_torch.ops import masks
from video_filler_tpu_torch.utils import save_gif, save_png


def _load_padded_frames(opt: Opt, corpus: VideoCorpus,
                        rs: np.random.RandomState, mask01: np.ndarray):
    """(frames, orig, padmask, geometry): frames (T, outH, outW, nc) in
    [-1,1], mask-filled and padded; orig the unpadded mask-filled frames;
    padmask (outH, outW, 1) uint8."""
    vid = rs.randint(len(corpus.suffixes))
    start = corpus.starts[vid] + rs.randint(corpus.counts[vid]
                                            - opt.predLen + 1)
    paths = corpus.get_clip(vid, start, opt.predLen)
    # the geometry of the video actually sampled (mixed-resolution corpora)
    sc_mask, padmask, (inh, inw, outh, outw) = frame_geometry(
        opt, corpus, vid, mask01)
    frames = np.zeros((opt.predLen, outh, outw, opt.nc), np.float32)
    orig = np.zeros((opt.predLen, inh, inw, opt.nc), np.float32)
    for t, p in enumerate(paths):
        im = decode.resize(decode.decode_image(p, opt.nc), inh, inw)
        im01 = im.astype(np.float32) / 255.0
        filled = np.where(sc_mask > 0, np.float32(opt.maskValue), im01)
        orig[t] = filled * 2.0 - 1.0
        frames[t, :inh, :inw] = filled
    frames = frames * 2.0 - 1.0  # the pad becomes -1, as in the reference
    return frames, orig, padmask, (inh, inw, outh, outw)


def run_wholeim(opt: Opt, out_dir: str | None = None
                ) -> dict[str, np.ndarray]:
    """Writes the PNGs and GIFs; returns pred, inpaint, input, orig and
    padmask.  A set ``initName`` runs the initializer cascade."""
    input_len = opt.inputLen or opt.predLen
    if opt.predLen % input_len:
        raise ValueError("predLen must divide by inputLen "
                         "(test_vid_wholeim.lua:41)")
    groups = opt.predLen // input_len
    device = resolve_device(opt)
    eval_opt = opt.replace(predLen=input_len)
    gen = load_generator(eval_opt, "video", opt.net)
    init_gen = (load_generator(eval_opt, "video", opt.initName)
                if opt.initName else None)

    rs = np.random.RandomState(opt.manualSeed or None)
    corpus = VideoCorpus(opt.DATA_ROOT,
                         variants=(("gt", 1.0 - opt.gt1Prob),
                                   ("gt1", opt.gt1Prob)))
    mask01 = decode.decode_image(opt.maskName, nc=1).astype(np.float32) / 255.0
    frames, orig, padmask, (inh, inw, outh, outw) = _load_padded_frames(
        opt, corpus, rs, mask01)
    fs = opt.fineSize
    n_tiles = (outh // fs) * (outw // fs)

    # every tile of every frame group in one batch:
    # (groups * n_tiles, fs, fs, nc * input_len)
    folded = frames.reshape(groups, input_len, outh, outw, opt.nc)
    folded = folded.transpose(0, 2, 3, 1, 4).reshape(groups, outh, outw,
                                                     input_len * opt.nc)
    tiles = [t for g in range(groups) for t in gather_tiles(folded[g], fs)]

    with torch.inference_mode():
        batch = torch.from_numpy(np.stack(tiles)).to(device)
        if init_gen is not None:
            tile_mask = torch.from_numpy(
                np.stack(gather_tiles(padmask, fs) * groups)).to(device)
            batch = masks.fill_in(batch, tile_mask, init_gen(batch))
        out = gen(batch).float().cpu().numpy()

    # scatter back, the trick tiles flipped back
    pred = np.stack([scatter_tiles(out[g * n_tiles:(g + 1) * n_tiles],
                                   fs, outh, outw) for g in range(groups)])
    pred_frames = pred.reshape(groups, outh, outw, input_len, opt.nc)
    pred_frames = pred_frames.transpose(0, 3, 1, 2, 4).reshape(
        opt.predLen, outh, outw, opt.nc)
    # composite inside the mask only (test_vid_wholeim.lua:207-220)
    inpaint = np.where(padmask[None] > 0, pred_frames, frames)

    out_dir = out_dir or (f"{opt.name}_prl{opt.predLen}_inl{input_len}"
                          f"_ldsz{opt.loadSize}")
    os.makedirs(out_dir, exist_ok=True)
    for t in range(opt.predLen):
        save_png(f"{out_dir}/pred_{t + 1}.png", pred_frames[t])
        save_png(f"{out_dir}/inpaint_{t + 1}.png", inpaint[t])
        # the composite cropped to the frame (the reference saves only the
        # padded canvas, test_vid_wholeim.lua:207-237): comparable with orig_*
        save_png(f"{out_dir}/inpaint_crop_{t + 1}.png", inpaint[t, :inh, :inw])
        save_png(f"{out_dir}/orig_{t + 1}.png", orig[t])
    save_gif(f"{out_dir}_result.gif", pred_frames)
    save_gif(f"{out_dir}_inpaint.gif", inpaint[:, :inh, :inw])
    save_gif(f"{out_dir}_orig.gif", orig)
    return {"pred": pred_frames, "inpaint": inpaint, "input": frames,
            "orig": orig, "padmask": padmask}


if __name__ == "__main__":
    run_wholeim(from_args(sys.argv[1:]))
