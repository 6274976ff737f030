"""The whole video3d train step with f32 Adam against ``adamMomentsBf16=1``
(the counterpart of the JAX package's scripts/ablate_video3d_step.py).

The step is the one the loop runs (train/step.py: preprocess of a uint8
batch on the device, G, D three times, both backward passes, the loss
kernels, two Adam updates), full width (video3dLevels 5, predLen 4,
nBottleneck 4000, fineSize 128, bf16), at each batch given.  Each
configuration has only its own state alive; ms/step is the host clock
around 40 steps that end in a synchronize, after 3 warm-up steps.  The
port's bf16 moments are ``train/optim.py`` ``AdamBf16Moments``, a loop
over the parameters, against torch.optim.Adam's foreach passes.

    python -m video_filler_tpu_torch.scripts.ablate_video3d_step
        [BATCH ...] [device=cpu]

BATCH defaults to 32 and 128.  ``VF_SMOKE=1``: tiny widths in f32 at
32x32 (video3dLevels 3), 2 timed steps, for the CPU.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import torch

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.scripts.common import (
    describe,
    smoke,
    split_args,
    sync,
    tool_device,
)
from video_filler_tpu_torch.scripts.measure_remat import host_batch
from video_filler_tpu_torch.train.step import (
    init_train_state,
    make_preprocess,
    make_train_step,
)

ITERS = 40
WARMUP = 3


def bench_step(opt: Opt, device: torch.device, iters: int) -> float:
    """Seconds per video3d train step, preprocess included, each step on a
    fresh draw of the preprocess's decisions from one uint8 batch."""
    state = init_train_state(opt, "video3d", torch.Generator().manual_seed(0))
    preprocess = make_preprocess(opt, "video3d")
    step = make_train_step(opt, "video3d")
    raw = host_batch(opt, "video3d", device)
    gen = torch.Generator().manual_seed(0)
    for _ in range(WARMUP):
        metrics = step(state, preprocess(raw, gen))
    float(metrics["errD"])
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = step(state, preprocess(raw, gen))
    float(metrics["errD"])
    sync(device)
    return (time.perf_counter() - t0) / iters


def main(argv: list[str]) -> list[dict]:
    words, opts = split_args(argv)
    device = tool_device(opts)
    if opts:
        raise SystemExit(f"unknown options {sorted(opts)}")
    batches = [int(w) for w in words] or [32, 128]
    iters = 2 if smoke() else ITERS
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True   # as train/loop.py sets it
    print(describe(device), flush=True)
    rows = []
    for b in batches:
        base = Opt(batchSize=b, fineSize=128, nBottleneck=4000, predLen=4,
                   wtl2=0.999, weight_nomask=0.05, video3dLevels=5,
                   computeDtype="bfloat16", device=str(device))
        if smoke():
            base = base.replace(fineSize=32, nBottleneck=64, nef=8, ngf=8,
                                ndf=8, video3dLevels=3,
                                computeDtype="float32")
        for tag, opt in (("f32 Adam", base),
                         ("bf16 moments", base.replace(adamMomentsBf16=True))):
            dt = bench_step(opt, device, iters)
            print(f"video3d b={b:4d} {tag:14s} {dt * 1e3:8.2f} ms/step  "
                  f"{b / dt:8.1f} clips/s", flush=True)
            rows.append({"batch": b, "config": tag, "ms": dt * 1e3,
                         "clips_s": b / dt})
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps({"ablate_video3d_step": rows, "device": str(device)}),
          flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
