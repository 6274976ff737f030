"""Structured training observability, copied from
video_filler_tpu/utils/logger.py.

The reference prints a per-step line (epoch, step, timings, Err_G_L2,
Err_G_GDL, Err_G, Err_D — train.lua:448-455) and pushes image grids to a
`display` HTTP server.  Here: the same scalar keys go to stdout AND a JSONL
file (machine-readable: the experiment-ledger role of training_logs /
runtrainvid.sh); image grids go to PNG files (utils/io.py).
"""

from __future__ import annotations

import json
import os


class MetricsLogger:
    def __init__(self, name: str, log_dir: str = "logs", quiet: bool = False):
        self.quiet = quiet
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def log_step(self, epoch: int, step: int, total_steps: int,
                 metrics: dict, step_time: float, data_time: float) -> None:
        rec = {"epoch": epoch, "step": step, "time": round(step_time, 4),
               "data_time": round(data_time, 4),
               **{k: round(float(v), 5) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        if not self.quiet:
            print(f"Epoch: [{epoch}][{step:8d} / {total_steps:8d}]\t "
                  f"Time: {step_time:.3f}  DataTime: {data_time:.3f}   "
                  f"Err_G_L2: {metrics.get('errG_l2', -1):.4f}   "
                  f"Err_G_GDL: {metrics.get('errG_gdl', -1):.4f}   "
                  f"Err_G: {metrics.get('errG', -1):.4f}  "
                  f"Err_D: {metrics.get('errD', -1):.4f}")

    def log_eval(self, epoch: int, split: str, metrics: dict) -> None:
        """In-train eval record (Opt.evalEvery): keyed `eval_epoch` so step
        records and eval records coexist in one JSONL (the dashboard and
        any tail-reader can tell them apart by key)."""
        rec = {"eval_epoch": epoch, "split": split,
               **{k: round(float(v), 5) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        if not self.quiet:
            print(f"Eval [{epoch}] split={split} \t "
                  f"PSNR: {metrics.get('psnr_db', -1):.2f} dB  "
                  f"L2: {metrics.get('l2', -1):.4f}  "
                  f"hole-L2: {metrics.get('hole_l2', -1):.4f}  "
                  f"SSIM: {metrics.get('ssim', -1):.4f}")

    def log_epoch(self, epoch: int, niter: int, seconds: float) -> None:
        self._f.write(json.dumps({"epoch_end": epoch, "seconds":
                                  round(seconds, 3)}) + "\n")
        if not self.quiet:
            print(f"End of epoch {epoch} / {niter} \t "
                  f"Time Taken: {seconds:.3f}")

    def close(self):
        self._f.close()
