"""Ms/frame of the device function of wholeim full-frame composite
serving (the counterpart of the JAX package's
scripts/bench_serve_wholeim.py).

This times the server's own device function
(``InpaintServer._device_fns[0]``, serve.py ``_wholeim_frame_fn``): the
mask fill, the 3x3 patch grid sliced into 27 channels
(donkey_wholeim.lua:152-211), one batched G forward, the 2x2 predicted
patches scattered back and composited inside the mask
(test_vid_wholeim.lua:207-220), at the reference's 360x480 frame and
widths (nef 192, ngf 192, ndf 128, nBottleneck 6400,
train_wholeim_input.lua:40-43), bf16, without HTTP and host copies.  The
inputs go to the card once and each call takes the previous call's uint8
output as its input; the calls are timed on the host clock between two
synchronizations, on the thread that built and warmed up the server (the
function's wall time, host dispatch included), and on the card
``PROFILED`` more calls are traced for the device's busy time
(``busy_ms/frame``), as scripts/bench_serve_video_frame.py does.

The weights are the port's ``logo_wholeim`` ledger checkpoint where it is
present (``ledgers/lw_ledgers/checkpoints/lw_wi_final_999_state.npz``,
what ``python -m video_filler_tpu_torch.ledger logo_wholeim`` writes),
else a fresh init written to ``work`` (timing does not depend on the
weights' values); a line says which.

    python -m video_filler_tpu_torch.scripts.bench_serve_wholeim
        [batch ...] [iters=30] [work=DIR] [device=cpu]

``VF_SMOKE=1``: tiny widths in f32, batches 2 and 4, 2 calls, always a
fresh init.
"""

from __future__ import annotations

import os
import sys

import torch

from video_filler_tpu_torch.checkpoint import save_checkpoint
from video_filler_tpu_torch.checkpoint.ckpt import checkpoint_path
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.ledger.presets import PRESETS
from video_filler_tpu_torch.scripts.bench_serve_video_frame import (
    busy_text,
    time_chain,
)
from video_filler_tpu_torch.scripts.common import (
    card,
    describe,
    smoke,
    split_args,
    tool_device,
)
from video_filler_tpu_torch.serve import InpaintServer
from video_filler_tpu_torch.train.step import init_train_state

FRAME_H, FRAME_W = 360, 480  # reference corpus geometry (dataset.lua:360-378)
# the reference widths (train_wholeim_input.lua:40-43)
OPT = dict(nef=192, ngf=192, ndf=128, nBottleneck=6400,
           frameH=FRAME_H, frameW=FRAME_W, computeDtype="bfloat16",
           display=False)
BATCHES = (8, 32)
SMOKE = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, computeDtype="float32")
SMOKE_BATCHES = (2, 4)
MASK_BOX = (slice(40, 110), slice(60, 220))  # a logo-sized blob in the 2x2


def ledger_checkpoint() -> str:
    """Where the ``logo_wholeim`` ledger leaves its wholeim run's final
    checkpoint (its default work directory)."""
    preset = PRESETS["logo_wholeim"]
    return checkpoint_path(
        os.path.join("ledgers", preset.workdir, "checkpoints"),
        f"{preset.runs['wholeim'].opt['name']}_final", 999)


def time_rows(srv: InpaintServer, bs: int, device: torch.device,
              iters: int) -> dict:
    ms, busy = time_chain(srv, bs, MASK_BOX, device, iters)
    ms_frame = ms / bs
    here = card(device)
    print(f"ROW batch={bs} ms/batch={ms:.2f} ms/frame={ms_frame:.3f} "
          f"frames/s={1e3 / ms_frame:.0f}{busy_text(busy, bs)} on {here}",
          flush=True)
    return {"batch": bs, "ms_per_batch": ms, "ms_per_frame": ms_frame,
            "frames_per_sec": 1e3 / ms_frame, "device_busy_ms_per_batch":
            busy, "device": here}


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
    net = ledger_checkpoint()
    if not smoke() and os.path.exists(net):
        print(f"weights: the logo_wholeim ledger's {net}", flush=True)
    else:
        state = init_train_state(opt, "wholeim",
                                 torch.Generator().manual_seed(0))
        net = save_checkpoint(os.path.join(work, "checkpoints"), "bench_wi",
                              0, state, generator_only=True)
        del state
        print(f"no ledger checkpoint; fresh init -> {net}", flush=True)
    rows = []
    for bs in batches:
        srv = InpaintServer(opt.replace(batchSize=bs), "wholeim", net,
                            device_thread=False)
        try:
            rows.append(time_rows(srv, bs, device, iters))
        finally:
            srv.close()
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
