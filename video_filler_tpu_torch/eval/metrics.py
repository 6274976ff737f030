"""Quality and throughput metrics (counterpart of
video_filler_tpu/eval/metrics.py).

The reference publishes no PSNR/SSIM/L2 numbers; its quality control is
visual.  This module gives reconstruction metrics over sampled batches and
the generator's inference throughput, written as a markdown table.

CLI:
    python -m video_filler_tpu_torch.eval.metrics regime=video device=cuda \\
        net=checkpoints/... DATA_ROOT=... maskName=... [reportPath=metrics.md]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from video_filler_tpu_torch.config import Opt, from_args, resolve_device
from video_filler_tpu_torch.data.pipeline import make_sampler
from video_filler_tpu_torch.eval.common import (
    gen_input,
    generator_spec,
    load_generator,
)
from video_filler_tpu_torch.models import video3d_fine_size
from video_filler_tpu_torch.ops import losses, masks
from video_filler_tpu_torch.train.step import make_preprocess


def _prepare(opt: Opt, regime: str, batch):
    """(g_input, target, mask or None) for a preprocessed batch."""
    if regime == "center":
        ctx = masks.center_mask_fill(batch["real"], opt.overlapPred)
        return ctx, masks.extract_center(batch["real"]), None
    if regime in ("video", "video3d"):
        ctx = masks.apply_logo_mask(batch["real"], batch["mask"],
                                    opt.maskValue)
        return ctx, batch["real"], batch["mask"]
    if regime in ("logo", "wholeim"):
        return batch["masked"], batch["real"], batch.get("mask")
    raise ValueError(regime)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(opt: Opt, regime: str, n_batches: int = 8, seed: int = 222,
             loaded=None, draws: list | None = None) -> dict:
    """Reconstruction quality of ``opt.net`` (or of the ``loaded``
    generator) over ``n_batches`` sampled batches: full-frame and
    hole-only L2, PSNR and SSIM (range 2.0, [-1,1] images), with the
    across-batch population std of each.

    Full-frame rows are mask composites (prediction inside the hole, ground
    truth outside) for every regime, center included through the
    demo.lua:73-76 paste-back; hole-only L2 is taken on the raw prediction.
    Batches come from ``opt.evalSplit`` (``test`` with split<100 for
    held-out data).  The host sampler draws from RandomState(seed), the
    preprocess from torch.Generator(seed), or from ``draws[i]`` for batch i
    (the regime's decision dict, train/step.py ``*_draws``).  A noiseGen G
    gets one z per batch: ``draws[i]["z"]`` when given, else the next draw
    of the same generator (video_filler_tpu/eval/metrics.py:80-82)."""
    device = resolve_device(opt)
    sampler, _ = make_sampler(opt, regime, split=opt.evalSplit)
    preprocess = make_preprocess(opt, regime)
    gen = loaded if loaded is not None else load_generator(opt, regime,
                                                           opt.net)
    rs = np.random.RandomState(seed)
    draw_gen = torch.Generator().manual_seed(seed)

    l2s, psnrs, hole_l2s, ssims = [], [], [], []
    with torch.inference_mode():
        for i in range(n_batches):
            host = sampler(rs)
            batch = preprocess(
                {k: torch.from_numpy(v).to(device) for k, v in host.items()},
                draw_gen, draws=None if draws is None else draws[i])
            ctx, target, mask = _prepare(opt, regime, batch)
            z = None if draws is None else draws[i].get("z")
            pred = gen(gen_input(opt, ctx, draw_gen, z))
            if regime == "center":
                # hole metrics in the predicted crop; full-frame metrics on
                # the crop pasted into the real 128² frame
                hole_pred, hole_target = pred, target
                target = batch["real"]
                pred_full = masks.paste_center(target, pred, opt.overlapPred)
            elif mask is not None:
                pred_full = masks.fill_in(target, mask, pred)
            else:
                pred_full = pred
            l2s.append(losses.mse(pred_full, target).item())
            psnrs.append(losses.psnr(pred_full, target).item())
            if pred_full.dim() == 5:  # clips: frames into the batch for SSIM
                ssims.append(losses.ssim(pred_full.flatten(0, 1),
                                         target.flatten(0, 1)).item())
            else:
                ssims.append(losses.ssim(pred_full, target).item())
            if regime == "center":
                hole_l2s.append(losses.mse(hole_pred, hole_target).item())
            elif mask is not None:
                m = mask.bool().expand(pred.shape)
                sq = (pred.float() - target.float()).square()
                denom = m.sum().clamp(min=1).float()
                hole_l2s.append(
                    (torch.where(m, sq, 0.0).sum() / denom).item())
            else:
                hole_l2s.append(losses.mse(pred, target).item())
    return {
        "l2": float(np.mean(l2s)),
        "psnr_db": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "hole_l2": float(np.mean(hole_l2s)),
        "l2_std": float(np.std(l2s)),
        "psnr_db_std": float(np.std(psnrs)),
        "ssim_std": float(np.std(ssims)),
        "hole_l2_std": float(np.std(hole_l2s)),
        "n_batches": n_batches,
        "batchSize": opt.batchSize,
    }


def bench_inference(opt: Opt, regime: str, iters: int = 50,
                    loaded=None) -> dict:
    """Generator inference throughput on a synthetic batch of
    ``opt.batchSize``: one warm-up forward, then ``iters`` forwards between
    two device synchronizations, timed on the host clock.  video3d takes
    (B,T,S,S,nc) clips, S = 4 * 2**video3dLevels; the 2-D regimes
    (B,128,128,nc_in), with one fixed z for a noiseGen G."""
    device = resolve_device(opt)
    gen = loaded if loaded is not None else load_generator(opt, regime,
                                                           opt.net)
    if regime == "video3d":
        side = video3d_fine_size(opt)
        shape = (opt.batchSize, opt.predLen, side, side, opt.nc)
    else:
        shape = (opt.batchSize, 128, 128, generator_spec(opt, regime).nc_in)
    x = torch.from_numpy(np.random.RandomState(0).rand(*shape)
                         .astype(np.float32) * 2 - 1).to(device)
    x = gen_input(opt, x, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        gen(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            gen(x)
        _sync(device)
        dt = (time.perf_counter() - t0) / iters
    frames_per_clip = max(opt.predLen, 1)
    return {
        "clips_per_sec": opt.batchSize / dt,
        "frames_per_sec": opt.batchSize * frames_per_clip / dt,
        "batch_latency_ms": dt * 1e3,
    }


def write_report(path: str, regime: str, quality: dict, speed: dict) -> None:
    lines = [
        f"# Metrics — regime `{regime}`", "",
        "| Metric | Value |", "|---|---|",
        f"| full-frame L2 ([-1,1] space) | {quality['l2']:.5f} |",
        f"| hole-only L2 | {quality['hole_l2']:.5f} |",
        f"| PSNR | {quality['psnr_db']:.2f} dB |",
        f"| SSIM | {quality['ssim']:.4f} |",
        f"| inference clips/s | {speed['clips_per_sec']:.1f} |",
        f"| inference frames/s | {speed['frames_per_sec']:.1f} |",
        f"| batch latency | {speed['batch_latency_ms']:.2f} ms |",
        "",
        f"(batches={quality['n_batches']}, batchSize={quality['batchSize']}; "
        "full-frame rows are mask-composites — prediction inside the hole, "
        "ground truth outside)",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv: list[str]) -> None:
    regime = "center"
    report_path = "metrics.md"
    rest = []
    for a in argv:
        k, _, v = a.partition("=")
        if k == "regime":
            regime = v
        elif k == "reportPath":
            report_path = v
        else:
            rest.append(a)
    opt = from_args(rest)
    gen = load_generator(opt, regime, opt.net)
    quality = evaluate(opt, regime, loaded=gen)
    speed = bench_inference(opt, regime, loaded=gen)
    write_report(report_path, regime, quality, speed)
    print(json.dumps({**quality, **speed}))


if __name__ == "__main__":
    main(sys.argv[1:])
