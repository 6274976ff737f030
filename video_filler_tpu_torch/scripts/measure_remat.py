"""Remat's trade of activation memory for FLOPs on the train step (the
counterpart of the JAX package's scripts/measure_remat.py).

Four configurations of one regime: plain, ``remat=1`` (G's and each D's
apply under ``torch.utils.checkpoint``, recomputed in the backward),
``gradAccum=8`` (eight microbatches) and both.  PyTorch has no memory
analysis before a run, so each is measured on one real step: after a
first step (which makes Adam's moments and lets cuDNN pick its
algorithms), the peak statistics are reset and a second step runs;
``state`` is what was allocated before it (parameters, moments, the
batch), ``peak`` the most allocated during it, ``step`` their difference
(activations, gradients, workspaces).  FLOPs are
``torch.utils.flop_counter.FlopCounterMode``'s count of a third step
(convolutions and matrix products, forward and backward, recompute
included).

    python -m video_filler_tpu_torch.scripts.measure_remat [regime=center]
        [batch=N] [device=cpu] [key=value ...]

Without ``regime=`` both cells run: center at batch 512 (bench.py's
training configuration: nBottleneck 4000, wtl2 0.999, overlapPred 4) and
video3d at batch 64 (predLen 4, video3dLevels 5, weight_nomask 0.05), full
width, bf16.  Other ``key=value`` options go over the cell's.  On the CPU
only the FLOPs are counted (memory: not measured).  ``VF_SMOKE=1``: tiny
widths in f32 at batch 16.
"""

from __future__ import annotations

import gc
import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from video_filler_tpu_torch.config import Opt, from_args
from video_filler_tpu_torch.scripts.common import (
    describe,
    smoke,
    split_args,
    sync,
    tool_device,
)
from video_filler_tpu_torch.train.step import (
    init_train_state,
    make_preprocess,
    make_train_step,
)

CELLS = {
    "center": (512, dict(nBottleneck=4000, wtl2=0.999, overlapPred=4)),
    "video3d": (64, dict(nBottleneck=4000, wtl2=0.999, predLen=4,
                         video3dLevels=5, weight_nomask=0.05)),
}
SMOKE = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, computeDtype="float32")
SMOKE_VIDEO3D = dict(video3dLevels=3, fineSize=32)
CONFIGS = (("plain", {}), ("remat", {"remat": 1}),
           ("gradAccum=8", {"gradAccum": 8}),
           ("remat+gradAccum=8", {"remat": 1, "gradAccum": 8}))


def host_batch(opt: Opt, regime: str, device: torch.device) -> dict:
    """A uint8 batch of the regime on ``device``: center frames, or
    channel-folded video clips with a mask over their middle third."""
    b, s = opt.batchSize, opt.fineSize
    g = torch.Generator().manual_seed(0)
    if regime == "center":
        return {"raw": torch.randint(0, 256, (b, s, s, opt.nc), generator=g,
                                     dtype=torch.uint8).to(device)}
    raw = torch.randint(0, 256, (b, s, s, opt.nc * opt.predLen), generator=g,
                        dtype=torch.uint8).to(device)
    q = s // 3
    mask = torch.zeros(b, s, s, 1, dtype=torch.uint8)
    mask[:, q:2 * q, q:2 * q] = 1
    return {"raw": raw, "mask": mask.to(device)}


def measure(opt: Opt, regime: str, device: torch.device) -> dict:
    """One configuration: memory of its second step (on the card) and the
    FLOPs of its third."""
    state = init_train_state(opt, regime, torch.Generator().manual_seed(0))
    batch = make_preprocess(opt, regime)(host_batch(opt, regime, device),
                                         torch.Generator().manual_seed(0))
    step = make_train_step(opt, regime)
    step(state, batch)
    sync(device)
    out = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        out["state_mib"] = torch.cuda.memory_allocated(device) / 2 ** 20
        step(state, batch)
        sync(device)
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2 ** 20
        out["step_mib"] = out["peak_mib"] - out["state_mib"]
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
        sync(device)
    out["gflops"] = counter.get_total_flops() / 1e9
    return out


def run_cell(regime: str, batch: int, over: list[str],
             device: torch.device) -> list[dict]:
    rows = []
    base = dict(CELLS[regime][1])
    if smoke():
        base.update(SMOKE, **(SMOKE_VIDEO3D if regime == "video3d" else {}))
    print(f"{regime}, batch {batch}: {base} {' '.join(over)}", flush=True)
    for label, cfg in CONFIGS:
        opt = from_args(over, Opt(**{**base, "batchSize": batch,
                                     "device": str(device), **cfg}))
        m = measure(opt, regime, device)
        mem = ("peak {peak_mib:9.1f} MiB  state {state_mib:9.1f} MiB  "
               "step {step_mib:9.1f} MiB".format(**m)
               if "peak_mib" in m else "memory not measured")
        print(f"{label:>20}: {mem}  flops {m['gflops']:10.1f} G",
              flush=True)
        rows.append({"regime": regime, "batch": batch, "config": label, **m})
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv: list[str]) -> list[dict]:
    words, opts = split_args(argv)
    if words:
        raise SystemExit(f"expected key=value options, got {words}")
    device = tool_device(opts)
    regime = opts.pop("regime", None)
    if regime is not None and regime not in CELLS:
        raise SystemExit(f"regime={regime}: measured for "
                         f"{', '.join(CELLS)}")
    batch = opts.pop("batch", None)
    over = [f"{k}={v}" for k, v in opts.items()]
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    print(describe(device), flush=True)
    rows = []
    for r in [regime] if regime else list(CELLS):
        b = int(batch) if batch else (16 if smoke() else CELLS[r][0])
        rows += run_cell(r, b, over, device)
    print(json.dumps({"measure_remat": rows, "device": str(device)}),
          flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
