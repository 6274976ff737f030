"""The learning-dynamics ledger protocol (counterpart of
scripts/ledger_common.py): train a configuration and score its generator
at init, along the way and at the end, on each split, through
eval/metrics.evaluate (n_batches=16 with the ``*_std`` dispersion
columns), one row per (checkpoint, split) in the JAX package's schema:
``regime, ckpt, evalSplit`` and every ``evaluate`` value rounded to 4
places, printed as a ``ROW`` line.
"""

from __future__ import annotations

import gc
import json
import os
import shutil

import torch

from video_filler_tpu_torch.checkpoint import (
    checkpoint_path,
    save_checkpoint,
    wait_pending_saves,
)
from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.eval.common import live_generator
from video_filler_tpu_torch.eval.metrics import evaluate
from video_filler_tpu_torch.train.loop import train
from video_filler_tpu_torch.train.step import init_train_state

__all__ = ["emit_row", "json_flusher", "run_ledger", "score"]


def json_flusher(path: str, rows: list):
    """A no-argument callable that writes ``rows`` to ``path`` as JSON
    (tmp + rename); pass it as ``run_ledger(flush=...)`` so every row is on
    disk the moment it is scored.  A ``path`` that exists already (a
    partial curve of an earlier attempt) is first copied to the first free
    ``path.prevN``, so a retry that dies earlier than that attempt never
    loses its longer curve; ``path`` keeps the old rows until the first
    flush."""
    if os.path.exists(path):
        n = 1
        while os.path.exists(f"{path}.prev{n}"):
            n += 1
        shutil.copyfile(path, f"{path}.prev{n}")

    def flush():
        with open(path + ".tmp", "w") as f:
            json.dump(rows, f, indent=1)
        os.replace(path + ".tmp", path)
    return flush


def emit_row(results: list, row: dict, flush=None) -> None:
    """Append ``row``, print it as a ``ROW`` line, flush."""
    results.append(row)
    print("ROW", json.dumps(row), flush=True)
    if flush is not None:
        flush()


def score(opt: Opt, regime: str, tag: str, splits, results: list,
          n_batches: int, net: str = "(live)", loaded=None, flush=None,
          extra: dict | None = None) -> None:
    """One row per split for the generator of checkpoint ``net``, or the
    ``loaded`` one: appended to ``results``, printed, flushed.  ``extra``
    keys (a run's departures from its preset) end every row."""
    for es in splits:
        m = evaluate(opt.replace(net=net, evalSplit=es), regime,
                     n_batches=n_batches, loaded=loaded)
        emit_row(results, {"regime": regime, "ckpt": tag, "evalSplit": es,
                           **{k: round(float(v), 4) for k, v in m.items()},
                           **(extra or {})}, flush)


def _release(device: torch.device) -> None:
    """Return a dropped state's memory before the next one is built (the
    video3d G alone holds 279 M parameters)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _final_tag(final_tag: str, state) -> str:
    """The step the run reached, not the caller's arithmetic."""
    real = f"step{state.step}"
    if real != final_tag:
        print(f"final_tag {final_tag} != actual {real}; using actual",
              flush=True)
    return real


def run_ledger(opt: Opt, regime: str, splits, results: list, mid_tag: str,
               final_tag: str, max_steps: int = 3000, n_batches: int = 16,
               save: bool = True, score_every: int | None = None,
               flush=None, extra: dict | None = None) -> None:
    """Train ``opt`` for at most ``max_steps`` steps and score its
    generator on each split, appending rows to ``results``; ``flush`` (a
    no-argument callable) runs after every row.

    The initial state is the run's own (the loop's init from
    ``manualSeed``); it is scored or saved, then freed before training.

    The final row is tagged with the step the run reached: a ``final_tag``
    that differs is reported and replaced (the loop clamps ntrain to the
    split's size, and a SIGTERM or ``max_steps`` ends a run early).

    ``save=True``: init, mid (the ``checkpointEvery``'th epoch's file) and
    final checkpoints in the loop's layout, tagged ``init``, ``mid_tag``
    and the final tag, each scored from its file through ``net=`` once the
    writes are done.  The final file is the loop's last epoch's, else one
    written here as ``<name>_final_999``.

    ``save=False``: nothing is written (pair it with checkpointEvery >
    niter); the live generator is scored in place
    (eval/common.live_generator) at init, every ``score_every`` epochs
    through the loop's ``epoch_hook`` (tagged ``step<global step>``) and at
    the end."""
    device = resolve_device(opt)
    state0 = init_train_state(opt, regime,
                              torch.Generator().manual_seed(opt.manualSeed))
    kw = dict(n_batches=n_batches, flush=flush, extra=extra)
    if not save:
        with live_generator(opt, regime, state0) as g:
            score(opt, regime, "init", splits, results, loaded=g, **kw)
        del state0, g
        _release(device)
        hook = None
        if score_every:
            def hook(epoch, state):
                if epoch % score_every:
                    return
                with live_generator(opt, regime, state) as g:
                    score(opt, regime, f"step{state.step}", splits, results,
                          loaded=g, **kw)
        state = train(opt, regime, max_steps=max_steps, epoch_hook=hook)
        real_tag = _final_tag(final_tag, state)
        with live_generator(opt, regime, state) as g:
            score(opt, regime, real_tag, splits, results, loaded=g, **kw)
        return
    p0 = save_checkpoint(opt.checkpointDir, f"{opt.name}_init", 0, state0)
    del state0
    _release(device)
    state = train(opt, regime, max_steps=max_steps)
    real_tag = _final_tag(final_tag, state)
    final = checkpoint_path(opt.checkpointDir, opt.name, opt.niter)
    if not os.path.exists(final):
        final = save_checkpoint(opt.checkpointDir, f"{opt.name}_final", 999,
                                state)
    del state
    _release(device)
    wait_pending_saves()
    mid = checkpoint_path(opt.checkpointDir, opt.name, opt.checkpointEvery)
    for tag, path in [("init", p0), (mid_tag, mid), (real_tag, final)]:
        if not os.path.exists(path):
            print(f"MISSING {path}", flush=True)
            continue
        score(opt, regime, tag, splits, results, net=path, **kw)
