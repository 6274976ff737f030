"""keepBest end to end (counterpart of scripts/run_keepbest_demo.py): a run
with in-train eval on the held-out split and ``keepBest=1`` banks its
best generator, and three checks hold the banked file to the run:

  1. its meta's ``bestMetric`` value equals the best of the loop's JSONL
     eval events (the JSONL rounds to 5 places, the meta does not);
  2. re-scoring the file through the ordinary ``net=`` path (a fresh
     ``evaluate`` on the same seeded eval stream) reproduces that value;
  3. the banked peak beats the final state whenever the curve's best is
     not its last point.

Each eval event, the re-score and the verdict are rows of the ledger
schema (``ROW`` lines; ``flush`` after each).
"""

from __future__ import annotations

import json
import os

from video_filler_tpu_torch.checkpoint import checkpoint_path, read_meta
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.eval.metrics import evaluate
from video_filler_tpu_torch.ledger.common import emit_row
from video_filler_tpu_torch.train.loop import _HIGHER_BETTER, train

__all__ = ["run_keepbest"]

_COLUMNS = ("l2", "psnr_db", "ssim", "hole_l2", "l2_std", "psnr_db_std",
            "ssim_std", "hole_l2_std")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"keepBest check failed: {what}")


def run_keepbest(opt: Opt, regime: str, rows: list, flush=None,
                 extra: dict | None = None) -> dict:
    """Train ``opt`` (evalEvery > 0, keepBest) from scratch, then make the
    three checks; a failed one raises RuntimeError.  Returns the banked
    meta, the curve's best and last values and the re-scored value."""
    metric = opt.bestMetric
    best_path = checkpoint_path(opt.checkpointDir, opt.name, "best")
    log = os.path.join("logs", f"{opt.name}.jsonl")
    for stale in (best_path, log):   # a retry must not read a prior attempt
        if os.path.exists(stale):
            os.remove(stale)
    state = train(opt, regime)
    steps_per_epoch = state.step // opt.niter
    del state
    extra = extra or {}

    # 1. the curve against the banked meta
    with open(log) as f:
        evals = [json.loads(line) for line in f if "eval_epoch" in line]
    _check(bool(evals), "no in-train eval events recorded")
    for e in evals:
        emit_row(rows, {
            "regime": regime,
            "ckpt": f"step{e['eval_epoch'] * steps_per_epoch}",
            "evalSplit": e["split"],
            **{k: e[k] for k in _COLUMNS if k in e}, **extra}, flush)
    meta = read_meta(best_path)
    pick = max if metric in _HIGHER_BETTER else min
    curve_best = pick(e[metric] for e in evals)
    _check(abs(meta[metric] - curve_best) < 1e-4,
           f"banked {metric} {meta[metric]} != the curve's best {curve_best}")
    print(f"CHECK1 ok: banked {metric}={meta[metric]:.5f} == curve best "
          f"{curve_best:.5f} (epoch {meta['epoch']}, step {meta['step']})",
          flush=True)

    # 2. the ordinary net= eval path reproduces the banked value
    m = evaluate(opt.replace(net=best_path), regime,
                 n_batches=opt.evalBatches)
    emit_row(rows, {
        "regime": regime, "ckpt": "best-rescored", "evalSplit": opt.evalSplit,
        **{k: round(float(v), 4) for k, v in m.items()}, **extra}, flush)
    rescored = float(m[metric])
    _check(abs(rescored - meta[metric]) < 5e-4,
           f"{best_path} rescores to {rescored}, banked {meta[metric]}")
    print(f"CHECK2 ok: net={best_path} rescores to {metric}={rescored:.5f} "
          f"(banked {meta[metric]:.5f})", flush=True)

    # 3. the peak against the final state
    final = evals[-1][metric]
    beats = (meta[metric] > final if metric in _HIGHER_BETTER
             else meta[metric] < final)
    verdict = ("banked peak BEATS final state" if beats
               else "final state is the peak (monotone run)")
    _check(beats or curve_best == final,
           f"the banked peak {meta[metric]} does not beat the final state's "
           f"{final}, though the curve's best is not its last point")
    emit_row(rows, {
        "regime": regime, "ckpt": "final-vs-best", "evalSplit": opt.evalSplit,
        f"{metric}_final": final, f"{metric}_best": meta[metric],
        "best_step": meta["step"], "verdict": verdict, **extra}, flush)
    print(f"CHECK3: {verdict} (final {final:.5f} vs best "
          f"{meta[metric]:.5f} @step {meta['step']})", flush=True)
    return {"meta": meta, "curve_best": curve_best, "final": final,
            "rescored": rescored, "evals": len(evals)}
