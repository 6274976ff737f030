"""Training throughput of the center train step on one card (the
counterpart of the JAX package's bench.py); the last line printed is ONE
JSON line with bench.py's keys.

    python -m video_filler_tpu_torch.bench [device=cpu]

Metric: training clips/s on the canonical center-mask model (fineSize
128, nBottleneck 4000, wtl2 0.999, overlapPred 4, bf16) at batch 512.
Baseline: the reference's ~1.455 s a batch of 64, about 44 images/s, on
its own CUDA GPU (training_logs:1, BASELINE.md:8-10).

What is timed is the step as training runs it (train/step.py): one
resident uint8 batch (``RandomState(0)``), preprocessed on the card
(flip, normalise, the center hole filled), G, D three times, the
backward and two Adam updates.  Each step's preprocess draws come from a
CPU generator seeded with the step's seed: 0-2 for the warm-up, 100+i for
the i-th timed step.  ``ITERS`` steps are timed on the host clock between
two ``torch.cuda.synchronize()``: the 2-D step is host-bound, so CUDA
events alone would hide the gaps a user waits through.  On the card
``PROFILED`` more steps are traced (torch.profiler) for the device's busy
time a step and its idle share of the timed step.  Then the same at
batch 64.

The step's unique memory traffic (``step_bytes``), each byte read once
and written once, from the port's own tensors:

    bytes = 2 * (W + G + M + C + A) + R

W the parameters of G and D, G their gradients, M Adam's two moments
(each 4 bytes an element in f32), C the compute-dtype copy of every
convolution weight (2 bytes an element in bf16; none in f32), A the
activations saved for the backward, taken as the step's allocation above
the state (the peak of a warm-up step less what was allocated before it,
as scripts/measure_remat.py measures it), and R the uint8 batch, read
once.  ``hbm_gbps_achieved`` is the batch-64 step's bytes over its time,
``pct_of_streaming_roofline`` its share of the H100's published 3.35
TB/s (NVIDIA's data sheet; the card's power limit is printed before).  A
share over 100% is a counting error and raises.  On the CPU the three
device numbers are null (not measured).

Before the JSON line: the card's name and power limit, and its streaming
rate measured here, a device-to-device copy of 1 GiB (bytes read plus
bytes written over the time, CUDA events).  ``VF_SMOKE=1``: tiny widths
in f32 at batches 8 and 4, 3 timed steps each.
"""

from __future__ import annotations

import json
import math
import sys

import numpy as np
import torch

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.scripts.common import (
    card,
    describe,
    device_busy_ms,
    smoke,
    split_args,
    sync,
    time_ms,
    tool_device,
    wall_ms,
)
from video_filler_tpu_torch.train.step import (
    init_train_state,
    make_preprocess,
    make_train_step,
)

BASELINE_IMAGES_PER_SEC = 44.0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory, NVIDIA's data sheet
STREAM_BYTES = 2 ** 30

OPT = dict(batchSize=512, fineSize=128, nBottleneck=4000, wtl2=0.999,
           overlapPred=4, computeDtype="bfloat16")
BATCHES = (512, 64)
SMOKE = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, computeDtype="float32")
SMOKE_BATCHES = (8, 4)
WARMUP = 3
ITERS, SMOKE_ITERS = 100, 3
PROFILED = 5


def fused_step(opt: Opt):
    """``fused(state, raw, step_seed) -> metrics``: the preprocess of the
    uint8 batch ``raw`` with the draws of ``step_seed``, then one train
    step (bench.py's ``_fused``)."""
    preprocess = make_preprocess(opt, "center")
    train_step = make_train_step(opt, "center")

    def fused(state, raw, step_seed):
        batch = preprocess({"raw": raw},
                           torch.Generator().manual_seed(step_seed))
        return train_step(state, batch)
    return fused


def raw_batch(opt: Opt, device: torch.device) -> torch.Tensor:
    rs = np.random.RandomState(0)
    return torch.from_numpy(rs.randint(
        0, 256, (opt.batchSize, opt.fineSize, opt.fineSize, opt.nc),
        dtype=np.uint8)).to(device)


def step_bytes(state, opt: Opt, activation_bytes: int) -> int:
    """The step's unique traffic (the module's formula) from ``state``'s
    tensors after a step: parameters, gradients, Adam moments."""
    params = [p for net in (state.gen, state.disc) for p in net.parameters()]
    weights = sum(p.nbytes for p in params)
    grads = sum(p.grad.nbytes for p in params if p.grad is not None)
    moments = sum(t.nbytes for o in (state.opt_g, state.opt_d)
                  for s in o.state.values() for k, t in s.items()
                  if k in ("exp_avg", "exp_avg_sq"))
    dtype = getattr(torch, opt.computeDtype)
    copies = 0 if dtype == torch.float32 else sum(
        p.numel() * dtype.itemsize for p in params if p.dim() == 4)
    batch = opt.batchSize * opt.fineSize ** 2 * opt.nc
    return 2 * (weights + grads + moments + copies + activation_bytes) + batch


def roofline(nbytes: int, ms: float) -> tuple[float, float]:
    """(GB/s, % of the published 3.35 TB/s) of ``nbytes`` in ``ms``."""
    rate = nbytes / (ms / 1e3)
    pct = 100.0 * rate / HBM_BYTES_PER_S
    if pct > 100.0:
        raise ValueError(f"{nbytes} bytes in {ms} ms is {pct:.1f}% of the "
                         f"card's {HBM_BYTES_PER_S / 1e12} TB/s: the byte "
                         "count is wrong")
    return rate / 1e9, pct


def time_step(opt: Opt, device: torch.device, iters: int) -> dict:
    """Milliseconds per fused step at ``opt.batchSize`` (``iters`` timed
    after ``WARMUP``) and, on the card, the step's bytes and the device's
    busy milliseconds a step (``PROFILED`` more steps)."""
    state = init_train_state(opt, "center", torch.Generator().manual_seed(0))
    fused = fused_step(opt)
    raw = raw_batch(opt, device)
    for i in range(WARMUP - 1):
        fused(state, raw, i)
    sync(device)
    nbytes = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        fused(state, raw, WARMUP - 1)
        sync(device)
        act = torch.cuda.max_memory_allocated(device) - before
        nbytes = step_bytes(state, opt, act)
    else:
        fused(state, raw, WARMUP - 1)
    out = {}
    ms = wall_ms(lambda i: out.update(m=fused(state, raw, 100 + i)), iters,
                 device)
    bad = {k: float(v) for k, v in out["m"].items()
           if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"batch {opt.batchSize}: metrics not finite "
                           f"after {iters} steps: {bad}")
    busy = None
    if device.type == "cuda":
        busy = device_busy_ms(lambda i: fused(state, raw, 100 + iters + i),
                              PROFILED)
    return {"ms": ms, "bytes": nbytes, "busy_ms": busy}


def stream_gbps(device: torch.device) -> float:
    """The card's streaming rate: a copy of ``STREAM_BYTES``, read plus
    written bytes over its time (CUDA events, 20 copies)."""
    src = torch.ones(STREAM_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), 20, device)
    return 2 * STREAM_BYTES / (ms / 1e3) / 1e9


def main(argv: list[str]) -> dict:
    words, opts = split_args(argv)
    device = tool_device(opts)
    iters = SMOKE_ITERS if smoke() else ITERS
    if words or opts:
        raise SystemExit(f"unknown arguments {words} {opts}: expected "
                         "[device=cpu]")
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True   # as the loop sets it
    here = card(device)
    print(describe(device), flush=True)
    if device.type == "cuda":
        print(f"streaming: {stream_gbps(device):.1f} GB/s (a copy of "
              f"{STREAM_BYTES} bytes, read + written) on {here}", flush=True)
    opt = Opt(**{**OPT, **(SMOKE if smoke() else {})}, device=str(device))
    b_big, b64 = SMOKE_BATCHES if smoke() else BATCHES
    legs = {}
    hbm = pct = None    # the last leg's, batch 64's, go into the JSON line
    for b in (b_big, b64):
        r = legs[b] = time_step(opt.replace(batchSize=b), device, iters)
        share = ""
        if r["bytes"] is not None:
            hbm, pct = roofline(r["bytes"], r["ms"])
            share = (f", {r['bytes']} bytes: {hbm:.1f} GB/s, {pct:.2f}% "
                     f"of 3.35 TB/s; device busy {r['busy_ms']:.3f} ms a "
                     f"step, idle {100 * (1 - r['busy_ms'] / r['ms']):.1f}%")
        print(f"batch {b}: {r['ms']:.3f} ms/step, "
              f"{b / (r['ms'] / 1e3):.1f} clips/s{share} on {here}",
              flush=True)
    clips = b_big / (legs[b_big]["ms"] / 1e3)
    line = {
        "metric": "train_clips_per_sec_per_chip",
        "value": round(clips, 2),
        "unit": f"clips/s (fineSize=128, batch={b_big}, center regime) "
                f"on {here}",
        "vs_baseline": round(clips / BASELINE_IMAGES_PER_SEC, 2),
        "batch64_ms_per_step": round(legs[b64]["ms"], 3),
        "hbm_gbps_achieved": None if hbm is None else round(hbm, 1),
        "pct_of_streaming_roofline": None if pct is None else round(pct, 2),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
