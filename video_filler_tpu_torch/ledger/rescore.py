"""Re-score the checkpoints a ledger work directory holds under the current
protocol (counterpart of scripts/rescore_ledgers.py and
scripts/reeval_center_ledger.py): no training, each file's generator
through ``evaluate`` (n_batches=16, with the ``*_std`` columns) on its
run's splits.

The runs are the presets that write checkpoints (``save=True``); a run's
files are ``<name>_init_0``, its ``checkpointEvery``'th epoch's and its
final one (the last epoch's, or ``<name>_final_999``).  A row is tagged
``init`` or ``step<the step stored in the file>`` and names its run
(``ledger``), as the JAX re-scores do.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from video_filler_tpu_torch.checkpoint import checkpoint_path
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.eval.metrics import evaluate
from video_filler_tpu_torch.ledger.common import emit_row, json_flusher
from video_filler_tpu_torch.ledger.presets import PRESETS

__all__ = ["RESULTS", "ledger_files", "rescore"]

RESULTS = "rescore_results.json"


def _saved_runs():
    """Every preset run that writes checkpoints, once by its run name."""
    runs = {}
    for preset in PRESETS.values():
        for run in preset.runs.values():
            if run.ledger.get("save", True):
                runs.setdefault(run.opt["name"], run)
    return runs


def ledger_files(opt: Opt) -> list[str]:
    """The ledger checkpoints of run ``opt.name`` present under
    ``opt.checkpointDir``, init first."""
    d, name = opt.checkpointDir, opt.name
    final = checkpoint_path(d, name, opt.niter)
    if not os.path.exists(final):
        final = checkpoint_path(d, f"{name}_final", 999)
    paths = [checkpoint_path(d, f"{name}_init", 0),
             checkpoint_path(d, name, opt.checkpointEvery), final]
    return [p for p in dict.fromkeys(paths) if os.path.exists(p)]


def _tag(path: str) -> str:
    if path.endswith("_init_0_state.npz"):
        return "init"
    with np.load(path, allow_pickle=False) as data:
        return f"step{int(data['.step'])}"


def rescore(workdir: str, overrides: dict | None = None,
            n_batches: int = 16, results: str = RESULTS) -> list[dict]:
    """Score every ledger checkpoint under ``workdir``/checkpoints; rows go
    to ``workdir``/``results`` (json_flusher: after each row, an earlier
    file kept as ``.prevN``) and are returned.  ``overrides``: Opt fields
    set over each run's preset (``device``, or the widths of a tiny run)."""
    rows: list[dict] = []
    with contextlib.chdir(workdir):
        flush = json_flusher(results, rows)
        for name, run in _saved_runs().items():
            opt = Opt(**{**run.opt, **(overrides or {})})
            for path in ledger_files(opt):
                tag = _tag(path)
                for es in run.splits:
                    m = evaluate(opt.replace(net=path, evalSplit=es),
                                 run.regime, n_batches=n_batches)
                    emit_row(rows, {"regime": run.regime, "ledger": name,
                                    "ckpt": tag, "evalSplit": es,
                                    **{k: round(float(v), 4)
                                       for k, v in m.items()}}, flush)
    return rows
