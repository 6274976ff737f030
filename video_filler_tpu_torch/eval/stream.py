"""Streaming whole-video inpainting (counterpart of
video_filler_tpu/eval/stream.py).

The reference's flagship eval (test_vid_wholeim.lua) processes one random
predLen-frame window per run; cleaning a whole broadcast means rerunning it
thousands of times.  This eval walks one video in consecutive predLen
windows through the tiled pipeline of eval/wholeim.py (gt(0.3) mask,
pad-to-tiles, vflip-top-tiles trick, composite inside the mask), decoding
window k+1 on a host thread while the device runs window k, and writes the
inpainted frames as PNGs plus a GIF of the first GIF_MAX_FRAMES.

The tiles cross to the device as uint8 and are normalized there; the
prediction comes back as uint8.

CLI:
    python -m video_filler_tpu_torch.eval.stream device=cuda DATA_ROOT=... \\
        maskName=... net=checkpoints/<name>_<epoch>_state.npz predLen=4 \\
        loadSize=240 [video=0] [startFrame=1] [numFrames=64] [name=out]
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
from video_filler_tpu_torch.ops.image import (
    denormalize_to_uint8,
    normalize_uint8,
)
from video_filler_tpu_torch.utils import save_gif, save_png

GIF_MAX_FRAMES = 64


def _load_window(opt: Opt, paths, sc_mask, geom) -> np.ndarray:
    """One window as uint8 (T, outH, outW, nc), mask-filled and padded.
    The pad value 0 is the reference's -1 after normalizing (a zero canvas
    written before ``mul(2):add(-1)``)."""
    inh, inw, outh, outw = geom
    fill = np.uint8(round(opt.maskValue * 255.0))
    frames = np.zeros((len(paths), outh, outw, opt.nc), np.uint8)
    for t, p in enumerate(paths):
        im = decode.resize(decode.decode_image(p, opt.nc), inh, inw)
        frames[t, :inh, :inw] = np.where(sc_mask > 0, fill, im)
    return frames


def _tiles_of(frames: np.ndarray, fs: int, nc: int) -> np.ndarray:
    """(T, outH, outW, nc) -> one (tiles, fs, fs, nc*T) batch."""
    t, outh, outw, _ = frames.shape
    folded = frames.transpose(1, 2, 0, 3).reshape(outh, outw, t * nc)
    return np.stack(gather_tiles(folded, fs))


def _scatter(out: np.ndarray, fs: int, nc: int, t: int, outh: int,
             outw: int) -> np.ndarray:
    pred = scatter_tiles(out, fs, outh, outw)
    return pred.reshape(outh, outw, t, nc).transpose(2, 0, 1, 3)


def run_stream(opt: Opt, video: int = 0, start_frame: int | None = None,
               num_frames: int | None = None, out_dir: str | None = None
               ) -> dict:
    """Returns the first GIF_MAX_FRAMES inpainted frames (uint8), the frame
    count and the frames per second of the whole loop.  A noiseGen G is
    refused, as the JAX package refuses it (its eval/stream.py:67-68)."""
    if opt.noiseGen:
        raise ValueError("noiseGen does not compose with tiled whole-frame "
                         "eval (same guard as serve.py's frame mode)")
    device = resolve_device(opt)
    gen = load_generator(opt, "video", opt.net)
    corpus = VideoCorpus(opt.DATA_ROOT,
                         variants=(("gt", 1.0 - opt.gt1Prob),
                                   ("gt1", opt.gt1Prob)))
    mask01 = decode.decode_image(opt.maskName, nc=1).astype(np.float32) / 255.0
    sc_mask, padmask, geom = frame_geometry(opt, corpus, video, mask01)
    _, _, outh, outw = geom
    fs, nc, pl = opt.fineSize, opt.nc, opt.predLen

    # `is None`: frame numbers may start at 0 (VideoCorpus takes the
    # smallest), so startFrame=0 must not fall through to the default.
    start = corpus.starts[video] if start_frame is None else start_frame
    total = (corpus.counts[video] - (start - corpus.starts[video])
             if num_frames is None else num_frames)
    total -= total % pl
    if total <= 0:
        raise ValueError("no full predLen window in the requested range")

    def tiled_forward(tiles_u8: np.ndarray) -> np.ndarray:
        x = normalize_uint8(torch.from_numpy(tiles_u8).to(device))
        return denormalize_to_uint8(gen(x)).cpu().numpy()

    out_dir = out_dir or f"{opt.name}_stream"
    pm = padmask[None] > 0
    windows = [corpus.get_clip(video, start + k, pl)
               for k in range(0, total, pl)]
    # Only the GIF's frames stay in memory: the per-frame PNGs are the full
    # output, and a whole broadcast must not pile up on the host.
    head = []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool, torch.inference_mode():
        future = pool.submit(_load_window, opt, windows[0], sc_mask, geom)
        for k in range(len(windows)):
            frames = future.result()
            if k + 1 < len(windows):
                future = pool.submit(_load_window, opt, windows[k + 1],
                                     sc_mask, geom)
            pred = _scatter(tiled_forward(_tiles_of(frames, fs, nc)), fs, nc,
                            pl, outh, outw)
            inpaint = np.where(pm, pred, frames)
            for t in range(pl):
                save_png(f"{out_dir}/inpaint_{k * pl + t + 1:05d}.png",
                         inpaint[t])
            if k * pl < GIF_MAX_FRAMES:
                head.append(inpaint)
    dt = time.perf_counter() - t0
    fps = total / dt
    print(f"streamed {total} frames in {dt:.1f}s = {fps:.1f} frames/s")
    seq = np.concatenate(head)[:GIF_MAX_FRAMES]
    # PIL's GIF quantization is slow on long sequences: 64 frames at half
    # resolution (the PNGs are the full output).
    save_gif(f"{out_dir}_inpaint.gif", seq[:, ::2, ::2])
    return {"frames": seq, "n_frames": total, "fps": fps}


def main(argv: list[str]) -> None:
    extra = {"video": 0, "startFrame": None, "numFrames": None}
    rest = []
    for a in argv:
        k, _, v = a.partition("=")
        if k in extra:
            extra[k] = int(v)
        else:
            rest.append(a)
    run_stream(from_args(rest), video=extra["video"],
               start_frame=extra["startFrame"], num_frames=extra["numFrames"])


if __name__ == "__main__":
    main(sys.argv[1:])
