"""Shared tile pipeline of the whole-frame evals (wholeim.py, stream.py);
counterpart of video_filler_tpu/eval/tiling.py.

One implementation of the geometry and mask preparation and of the
vflip-top-tiles gather/scatter (test_vid_wholeim.lua:139-200), so the
single-window eval and the streaming eval cannot diverge on the
gt(0.3) threshold, the pad rule or the flip count.  Host numpy.
"""

from __future__ import annotations

import math

import numpy as np

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import decode
from video_filler_tpu_torch.ops import masks

VFLIP_TOP_TILES = 3  # the reference flips the first three top-row tiles
                     # (test_vid_wholeim.lua:167-171)


def frame_geometry(opt: Opt, corpus, video: int, mask01: np.ndarray):
    """Probe ``video``'s first frame for its aspect ratio and derive the
    tiled-eval geometry: scale to (loadSize, loadSize*W/H), pad
    bottom-right to fineSize multiples, gt(0.3)-binarize the scaled mask
    (test_vid_wholeim.lua:126-141).  The video actually processed is
    probed: on a mixed-resolution corpus video 0's aspect would distort the
    others.

    Returns (sc_mask (inH,inW,1), padmask (outH,outW,1) uint8,
    (inh, inw, outh, outw))."""
    probe = decode.decode_image(
        corpus.get_clip(video, corpus.starts[video], 1)[0], opt.nc)
    orih, oriw = probe.shape[:2]
    inh = opt.loadSize
    inw = round(opt.loadSize * oriw / orih)
    outh = math.ceil(inh / opt.fineSize) * opt.fineSize
    outw = math.ceil(inw / opt.fineSize) * opt.fineSize
    sc = decode.resize((mask01 * 255).astype(np.uint8), inh, inw)
    sc_mask = masks.binarize_mask(sc.astype(np.float32) / 255.0, "gt03")
    padmask = np.zeros((outh, outw, 1), np.uint8)
    padmask[:inh, :inw] = sc_mask
    return sc_mask, padmask, (inh, inw, outh, outw)


def gather_tiles(folded: np.ndarray, fs: int) -> list:
    """(outH, outW, C) -> row-major fineSize² tiles, the leftmost
    VFLIP_TOP_TILES of the top row flipped vertically: the mask sits in the
    top corner, where training crops rarely looked; flipped, it lands in
    familiar territory (test_vid_wholeim.lua:167-171).  Callers stack the
    list."""
    outh, outw = folded.shape[:2]
    tiles = []
    for th in range(outh // fs):
        for tw in range(outw // fs):
            t = folded[th * fs:(th + 1) * fs, tw * fs:(tw + 1) * fs]
            if th == 0 and tw < VFLIP_TOP_TILES:
                t = t[::-1]
            tiles.append(t)
    return tiles


def scatter_tiles(out: np.ndarray, fs: int, outh: int, outw: int
                  ) -> np.ndarray:
    """Inverse of gather_tiles: (nTiles, fs, fs, C) -> (outH, outW, C),
    the trick tiles flipped back (test_vid_wholeim.lua:194-200)."""
    pred = np.zeros((outh, outw, out.shape[-1]), out.dtype)
    i = 0
    for th in range(outh // fs):
        for tw in range(outw // fs):
            tile = out[i]
            if th == 0 and tw < VFLIP_TOP_TILES:
                tile = tile[::-1]
            pred[th * fs:(th + 1) * fs, tw * fs:(tw + 1) * fs] = tile
            i += 1
    return pred
