"""End-to-end training throughput through the loop, with the corpus
resident on the card (``dataDevice=1``) and with the host loader (the
counterpart of the JAX package's scripts/bench_e2e_datadevice.py).

``python -m video_filler_tpu_torch.bench`` times the step alone on one
resident batch.  This times ``train(opt, "center", epoch_hook=...,
quiet=True)``, the loop as users run it: the per-step batch, the loop's
logging, its metric flush and JSONL write at each epoch boundary.

Configuration: bench's model (fineSize 128, nBottleneck 4000, wtl2 0.999,
overlapPred 4, bf16) on a synthetic 1024-image corpus.  Three legs:
dataDevice at batch 512 (2 epochs of warm-up, 50 timed: 100 steps) and
at batch 64 (1 + 8), and the host loader at batch 64 with 4 threads
(1 + 2).  Each leg times whole epochs between two synchronizations of
the card in the epoch hook; epoch boundaries fall inside the window.  No
checkpoint is written (``checkpointEvery=9999``).

    python -m video_filler_tpu_torch.scripts.bench_e2e_datadevice
        [work=DIR] [device=cpu]

The corpus, the loop's logs and ``dd_e2e_results.json`` (the rows
``tag, batch, steps, seconds, ms_per_step, clips_per_sec`` and the
device, written after each leg) go to ``work`` (default
``ledgers/dd_e2e``), the directory the loop runs in.  ``VF_SMOKE=1``:
tiny widths in f32 on a 32-image corpus, batches 16 and 8.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time

import torch

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.ledger.common import json_flusher
from video_filler_tpu_torch.scripts.common import (
    card,
    describe,
    smoke,
    split_args,
    sync,
    tool_device,
)
from video_filler_tpu_torch.train.loop import train

N_IMAGES, SMOKE_IMAGES = 1024, 32
RESULTS = "dd_e2e_results.json"


def flagship(n_images: int) -> dict:
    return dict(DATA_ROOT="corpus", fineSize=128, nBottleneck=4000,
                wtl2=0.999, overlapPred=4, computeDtype="bfloat16",
                ntrain=n_images, manualSeed=222, display=False,
                logEvery=1000, checkpointEvery=9999, name="dd_e2e")


SMOKE = dict(nef=8, ngf=8, ndf=8, nBottleneck=64, computeDtype="float32")
# (tag, warm-up epochs, timed epochs, options)
LEGS = (("dataDevice", 2, 50, dict(batchSize=512, dataDevice=True,
                                   nThreads=0)),
        ("dataDevice", 1, 8, dict(batchSize=64, dataDevice=True,
                                  nThreads=0)),
        ("hostPipeline", 1, 2, dict(batchSize=64, nThreads=4)))
SMOKE_LEGS = (("dataDevice", 2, 5, dict(batchSize=16, dataDevice=True,
                                        nThreads=0)),
              ("dataDevice", 1, 2, dict(batchSize=8, dataDevice=True,
                                        nThreads=0)),
              ("hostPipeline", 1, 2, dict(batchSize=8, nThreads=4)))


def run_leg(tag: str, warm: int, timed: int, opt: Opt, n_images: int,
            device: torch.device) -> dict:
    """One leg: ``warm + timed`` epochs through ``train``, the timed ones
    between two synchronizations in the epoch hook."""
    t = {}

    def hook(epoch, state):
        if epoch in (warm, warm + timed):
            sync(device)
            t[epoch] = time.perf_counter()

    train(opt.replace(niter=warm + timed), "center", epoch_hook=hook,
          quiet=True)
    dt = t[warm + timed] - t[warm]
    steps = timed * (n_images // opt.batchSize)
    return {"tag": tag, "batch": opt.batchSize, "steps": steps,
            "seconds": round(dt, 3), "ms_per_step": round(1e3 * dt / steps, 3),
            "clips_per_sec": round(steps * opt.batchSize / dt, 1),
            "device": card(device)}


def main(argv: list[str]) -> list[dict]:
    words, opts = split_args(argv)
    device = tool_device(opts)
    work = opts.pop("work", os.path.join("ledgers", "dd_e2e"))
    if words or opts:
        raise SystemExit(f"unknown arguments {words} {opts}: expected "
                         "[work=DIR] [device=cpu]")
    n_images = SMOKE_IMAGES if smoke() else N_IMAGES
    base = {**flagship(n_images), **(SMOKE if smoke() else {}),
            "device": str(device)}
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True   # as the loop sets it
    print(describe(device), flush=True)
    os.makedirs(work, exist_ok=True)
    rows: list[dict] = []
    with contextlib.chdir(work):
        if not os.path.isdir("corpus"):
            synthetic.make_image_folder("corpus", n=n_images, h=160, w=200)
            print("corpus built", flush=True)
        flush = json_flusher(RESULTS, rows)
        for tag, warm, timed, kw in SMOKE_LEGS if smoke() else LEGS:
            rows.append(run_leg(tag, warm, timed, Opt(**{**base, **kw}),
                                n_images, device))
            flush()
            print("ROW", json.dumps(rows[-1]), flush=True)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    print("ALL-DONE", len(rows), os.path.join(work, RESULTS), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
