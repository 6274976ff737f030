"""Host data-pipeline throughput alone, native C++ decode against the
Python decode (the counterpart of the JAX package's
scripts/bench_loader.py).

The reference's training was data-bound (1.455 s a batch of 64 with its
donkey threads, training_logs:1).  This times the port's host pipeline
(data/pipeline.py ``make_sampler`` and ``DataLoader``) on a synthetic
360x480 video corpus and mask, for the video regime (predLen 4) and
wholeim (the full frame, translate and 3x3 patch slice), each with the
native decode and with the Python decode.

    python -m video_filler_tpu_torch.scripts.bench_loader [n_images]
        [batch] [threads] [seconds=20] [work=DIR] [device=cpu]

Each row times a fixed window of ``seconds`` after one warm-up batch.
The loader's in-flight capacity (3 batches a thread: 2 queued, 1 in the
worker's hands) was produced before the window opened, so that many
batches are not counted.  Where the native decode does not build
(``data.native.unavailable_reason()``), its row says why and times
nothing.  The loader runs on the host; the card's line names the machine
(the tool still refuses to run without a card unless ``device=cpu``).
The corpus goes to ``work`` (default ``ledgers/loader``).
``VF_SMOKE=1``: 16 frames, batch 4, 2 threads.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import native, synthetic
from video_filler_tpu_torch.data.pipeline import DataLoader, make_sampler
from video_filler_tpu_torch.scripts.common import (
    card,
    describe,
    smoke,
    split_args,
    tool_device,
)

FRAME_H, FRAME_W = 360, 480
REGIMES = (("video", 4), ("wholeim", 1))


@contextlib.contextmanager
def decode_path(use_native: bool):
    """``VF_NO_NATIVE`` for one row, restored after it."""
    old = os.environ.get("VF_NO_NATIVE")
    os.environ["VF_NO_NATIVE"] = "" if use_native else "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["VF_NO_NATIVE"]
        else:
            os.environ["VF_NO_NATIVE"] = old


def time_loader(opt: Opt, regime: str, seconds: float) -> tuple[int, float]:
    """(batches counted, seconds) of a window of ``seconds``, less the
    in-flight credit."""
    sampler, _ = make_sampler(opt, regime)
    loader = DataLoader(sampler, opt.nThreads, seed=1)
    try:
        loader.get_batch()   # warm the queue and the workers
        in_flight = max(opt.nThreads, 1) * 3
        t0 = time.perf_counter()
        nb = 0
        while time.perf_counter() - t0 < seconds or nb <= in_flight * 2:
            loader.get_batch()
            nb += 1
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    return max(nb - in_flight, 1), dt


def main(argv: list[str]) -> list[dict]:
    words, opts = split_args(argv)
    device = tool_device(opts)
    seconds = float(opts.pop("seconds", 20))
    work = opts.pop("work", os.path.join("ledgers", "loader"))
    if len(words) > 3 or opts:
        raise SystemExit(f"unknown arguments {words} {opts}: expected "
                         "[n_images] [batch] [threads] [seconds=S] "
                         "[work=DIR] [device=cpu]")
    n, batch, threads = ([int(w) for w in words]
                         + ([16, 4, 2] if smoke() else [512, 64, 8])
                         [len(words):])
    print(describe(device), flush=True)
    here = card(device)
    root = os.path.abspath(os.path.join(work, "corpus"))
    mask = os.path.join(root, "mask.png")
    if not os.path.isdir(os.path.join(root, "gt")):
        synthetic.make_video_corpus(root, n_videos=2, frames=max(n // 2, 8),
                                    h=FRAME_H, w=FRAME_W)
        synthetic.make_mask_png(mask, h=FRAME_H, w=FRAME_W)
    cores = os.cpu_count() or 1
    rows = []
    for regime, frames_per in REGIMES:
        for use_native in (True, False):
            label = "native C++" if use_native else "pure python"
            row = {"regime": regime, "decode": label, "batch": batch,
                   "threads": threads, "cores": cores, "host": here}
            if use_native and not native.available():
                row["unavailable"] = native.unavailable_reason()
                print(f"{regime} {label}: unavailable "
                      f"({row['unavailable']})", flush=True)
                rows.append(row)
                continue
            opt = Opt(DATA_ROOT=root, maskName=mask, loadSize=240,
                      fineSize=128, predLen=4, batchSize=batch,
                      nThreads=threads, device=str(device))
            with decode_path(use_native):
                nb, dt = time_loader(opt, regime, seconds)
            clips = nb * batch / dt
            frames = clips * frames_per
            row.update(samples_per_sec=clips, frames_per_sec=frames,
                       frames_per_sec_per_core=frames / cores, seconds=dt)
            rows.append(row)
            detail = ("predLen=4" if regime == "video"
                      else "full frame + translate + 3x3 slice")
            print(f"{regime} {label}: {clips:,.0f} samples/s = "
                  f"{frames:,.0f} frames decoded+processed/s on {cores} "
                  f"core(s) (= {frames / cores:,.0f} frames/s/core; "
                  f"{threads} loader threads, {detail}, loadSize=240); "
                  f"host of {here}", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
