"""Ms/frame of the device function of whole-frame video serving (the
counterpart of the JAX package's scripts/bench_serve_video_frame.py).

serve.py serves the reference's flagship inference (test_vid_wholeim.lua:
159-220): the video G tiled over a fineSize-padded whole frame, with the
vflip-top-tiles trick and the mask-only composite.  This times the
server's own device function (``InpaintServer._device_fns[0]``, serve.py
``_video_frame_fn``) at the reference's 360x480 frame (padded to 384x512,
12 tiles a frame) on the flagship model (fineSize 128, nBottleneck 4000,
predLen 4 channel-folded, bf16), without HTTP and host copies:

* the inputs go to the card once; each call takes the previous call's
  uint8 output frame as its input (same shape), so the calls run one
  after another and none can be skipped;
* the calls are timed on the host clock between two synchronizations,
  on the thread that built the server and warmed it up (cuDNN keeps its
  plans per thread): the function's wall time, host dispatch included;
* on the card ``PROFILED`` more calls are traced (torch.profiler) for
  the device's busy time a batch, its kernels' own time
  (``busy_ms/frame`` on the ROW line; null on the CPU).

Each item is a clip of predLen frames, so ms/frame = ms/clip / predLen.
A last row times the netI initializer cascade (``withInit=1``: a second
G-sized forward per tile batch).  The weights are a fresh init written
as a checkpoint to ``work`` (timing does not depend on their values).

    python -m video_filler_tpu_torch.scripts.bench_serve_video_frame
        [batch ...] [iters=30] [work=DIR] [device=cpu]

``VF_SMOKE=1``: tiny widths in f32, batches 2 and 4, 2 calls.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from video_filler_tpu_torch.checkpoint import save_checkpoint
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.scripts.common import (
    card,
    describe,
    device_busy_ms,
    smoke,
    split_args,
    tool_device,
    wall_ms,
)
from video_filler_tpu_torch.serve import InpaintServer
from video_filler_tpu_torch.train.step import init_train_state

FRAME_H, FRAME_W = 360, 480  # reference corpus geometry (dataset.lua:360-378)
PRED_LEN = 4
OPT = dict(nBottleneck=4000, predLen=PRED_LEN,      # flagship video model
           frameH=FRAME_H, frameW=FRAME_W,          # (train_vid_weighted.lua)
           computeDtype="bfloat16", display=False)
BATCHES = (4, 8)
SMOKE = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, computeDtype="float32")
SMOKE_BATCHES = (2, 4)
WARMUP = 3
PROFILED = 5
# a logo-sized top-corner blob (the vflip trick's reason to exist)
MASK_BOX = (slice(20, 80), slice(30, 150))


def device_inputs(srv: InpaintServer, bs: int, box, device: torch.device):
    """Random uint8 frames of the server's input shape and a mask of
    ``box`` (255 inside), both on ``device``."""
    rs = np.random.RandomState(0)
    mask = np.zeros((srv.in_h, srv.in_w, 1), np.uint8)
    mask[box] = 255
    frames = rs.randint(0, 256, (bs, srv.in_h, srv.in_w, srv.in_c),
                        np.uint8)
    return (torch.from_numpy(frames).to(device),
            torch.from_numpy(np.broadcast_to(mask, (bs,) + mask.shape)
                             .copy()).to(device))


def chain(fn, out: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` calls of the device function ``fn``, each on the previous
    call's output."""
    with torch.inference_mode():
        for _ in range(n):
            out = fn(out, mask)
    return out


def time_chain(srv: InpaintServer, bs: int, box, device: torch.device,
               iters: int) -> tuple[float, float | None]:
    """(wall, device-busy) milliseconds per batch of the server's device
    function, chained; the busy time only on the card."""
    frames, mask = device_inputs(srv, bs, box, device)
    fn = srv._device_fns[0]
    out = {"x": chain(fn, frames, mask, WARMUP)}   # past the ctor's warm-up

    def call(i):
        out["x"] = chain(fn, out["x"], mask, 1)
    ms = wall_ms(call, iters, device)
    busy = device_busy_ms(call, PROFILED) if device.type == "cuda" else None
    return ms, busy


def busy_text(busy: float | None, per: int) -> str:
    """The ROW line's device busy milliseconds a frame, on the card."""
    return "" if busy is None else f" busy_ms/frame={busy / per:.3f}"


def time_rows(srv: InpaintServer, bs: int, tag: str, device: torch.device,
              iters: int, extra: str = "") -> dict:
    ms, busy = time_chain(srv, bs, MASK_BOX, device, iters)
    ms_clip = ms / bs
    ms_frame = ms_clip / PRED_LEN
    here = card(device)
    print(f"ROW {tag} batch={bs}{extra} ms/batch={ms:.2f} "
          f"ms/clip={ms_clip:.3f} ms/frame={ms_frame:.3f} "
          f"frames/s={1e3 / ms_frame:.0f}{busy_text(busy, bs * PRED_LEN)} "
          f"on {here}", flush=True)
    return {"tag": tag, "batch": bs, "ms_per_batch": ms,
            "ms_per_clip": ms_clip, "ms_per_frame": ms_frame,
            "frames_per_sec": 1e3 / ms_frame, "device_busy_ms_per_batch":
            busy, "device": here}


def serve_rows(opt: Opt, net: str, batches, device: torch.device,
               iters: int) -> list[dict]:
    """The plain rows at each batch, then the withInit cascade (initName
    the same checkpoint) at the last."""
    rows = []
    for bs in batches:
        srv = InpaintServer(opt.replace(batchSize=bs), "video", net,
                            device_thread=False)
        try:
            rows.append(time_rows(srv, bs, "plain", device, iters))
        finally:
            srv.close()
    bs = batches[-1]
    srv = InpaintServer(opt.replace(batchSize=bs, withInit=True,
                                    initName=net), "video", net,
                        device_thread=False)
    try:
        rows.append(time_rows(srv, bs, "withInit", device, iters,
                              extra=" cascade"))
    finally:
        srv.close()
    return rows


def main(argv: list[str]) -> list[dict]:
    words, opts = split_args(argv)
    device = tool_device(opts)
    iters = int(opts.pop("iters", 2 if smoke() else 30))
    work = opts.pop("work", os.path.join("ledgers", "serve_bench"))
    if opts:
        raise SystemExit(f"unknown options {opts}: expected [batch ...] "
                         "[iters=N] [work=DIR] [device=cpu]")
    batches = ([int(w) for w in words]
               or list(SMOKE_BATCHES if smoke() else BATCHES))
    opt = Opt(**{**OPT, **(SMOKE if smoke() else {})}, device=str(device))
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True   # as the server sets it
    print(describe(device), flush=True)
    state = init_train_state(opt, "video", torch.Generator().manual_seed(0))
    net = save_checkpoint(os.path.join(work, "checkpoints"), "bench_vf", 0,
                          state, generator_only=True)
    del state
    print(f"fresh-init weights -> {net} (timing is value-independent)",
          flush=True)
    rows = serve_rows(opt, net, batches, device, iters)
    print("ALL-DONE", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
