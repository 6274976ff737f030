"""The ledgers' command line (the role of the JAX package's
``scripts/run_*.py`` and ``scripts/rescore_ledgers.py``):

    python -m video_filler_tpu_torch.ledger list
    python -m video_filler_tpu_torch.ledger <preset> [--regimes RUN ...]
        [--workdir DIR] [--device cuda|cpu] [--max-steps N]
        [--n-batches N] [key=value ...]
    python -m video_filler_tpu_torch.ledger rescore WORKDIR ...
        [--device cuda|cpu] [--n-batches N] [key=value ...]
    python -m video_filler_tpu_torch.ledger compare REF.json RUN.json

A preset builds its synthetic corpora in the work directory (default
``ledgers/<the script's work directory>`` under the current one) unless
they are there, runs its runs (``--regimes`` picks some by their keys),
and writes its result file there, every row as it lands.  ``key=value``
sets an option over each run's preset (``dataDevice=1``, ``manualSeed=223``,
or the widths of a tiny CPU run), and every row then carries it, as it
carries a ``--max-steps`` given.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import time

from video_filler_tpu_torch.config import Opt, _coerce
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.ledger.common import json_flusher, run_ledger
from video_filler_tpu_torch.ledger.compare import compare_files
from video_filler_tpu_torch.ledger.keepbest import run_keepbest
from video_filler_tpu_torch.ledger.presets import KEEPBEST, PRESETS
from video_filler_tpu_torch.ledger.rescore import rescore


def _preset(name: str):
    if name == "keepbest":
        return KEEPBEST
    if name not in PRESETS:
        raise SystemExit(f"unknown preset {name!r}; expected one of "
                         f"{', '.join([*PRESETS, 'keepbest'])}, or list, "
                         "rescore, compare")
    return PRESETS[name]


def parse_overrides(args: list[str]) -> dict:
    """``key=value`` options, coerced as the trainer's CLI coerces them (the
    environment is not read: a preset is the script's configuration)."""
    fields = {f.name: f.default for f in dataclasses.fields(Opt)}
    out = {}
    for arg in args:
        k, sep, v = arg.partition("=")
        if not sep:
            raise SystemExit(f"expected key=value, got {arg!r}")
        if k not in fields:
            raise SystemExit(f"unknown option {k!r}")
        try:
            out[k] = _coerce(v, fields[k])
        except ValueError as e:
            raise SystemExit(f"bad value for {k}: {e}") from None
    return out


def build_corpora(preset) -> None:
    """The preset's synthetic corpora in the current directory, each unless
    it is there."""
    for fn, args, kw in preset.corpora:
        if not os.path.exists(args[0]):
            getattr(synthetic, fn)(*args, **kw)
            print(f"built {args[0]}", flush=True)


def _device_line(device: str) -> None:
    if device != "cuda":
        return
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    print(out.splitlines()[0] if out else "nvidia-smi printed nothing",
          flush=True)


def run_preset(name: str, keys=None, workdir: str | None = None,
               device: str = "cuda", overrides: dict | None = None,
               max_steps: int | None = None,
               n_batches: int | None = None) -> list[dict]:
    """Run a preset (its runs ``keys``, default the script's) from
    ``workdir``; returns the rows it wrote."""
    preset = _preset(name)
    keys = tuple(keys or preset.default_runs())
    unknown = [k for k in keys if k not in preset.runs]
    if unknown:
        raise SystemExit(f"preset {name} has no run {unknown}; its runs: "
                         f"{', '.join(preset.runs)}")
    overrides = dict(overrides or {})
    extra = {k: int(v) if isinstance(v, bool) else v
             for k, v in overrides.items()}
    if max_steps is not None:
        extra["max_steps"] = max_steps
    workdir = workdir or os.path.join("ledgers", preset.workdir)
    os.makedirs(workdir, exist_ok=True)
    with contextlib.chdir(workdir):
        _device_line(device)
        build_corpora(preset)
        rows: list[dict] = []
        flush = json_flusher(preset.results_file(keys), rows)
        for key in keys:
            run = preset.runs[key]
            opt = Opt(**{**run.opt, "device": device, **overrides})
            t0 = time.perf_counter()
            if preset is KEEPBEST:
                run_keepbest(opt, run.regime, rows, flush, extra or None)
            else:
                kw = dict(run.ledger)
                if max_steps is not None:
                    kw["max_steps"] = max_steps
                if n_batches is not None:
                    kw["n_batches"] = n_batches
                run_ledger(opt, run.regime, run.splits, rows, run.mid_tag,
                           run.final_tag, flush=flush, extra=extra or None,
                           **kw)
            print(f"LEDGER {name} {key}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        print("ALL-DONE", len(rows), os.path.join(
            workdir, preset.results_file(keys)), flush=True)
        return rows


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m video_filler_tpu_torch.ledger",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", help="a preset, 'list', 'rescore' or "
                    "'compare'")
    ap.add_argument("rest", nargs="*", help="key=value options; for "
                    "rescore, the work directories too; for compare, the "
                    "two result files")
    ap.add_argument("--regimes", nargs="+", help="the preset's runs to make")
    ap.add_argument("--workdir")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--max-steps", type=int)
    ap.add_argument("--n-batches", type=int)
    a = ap.parse_intermixed_args(argv)
    # --regimes takes every word up to the next option: its key=value
    # words are options
    regimes = [r for r in a.regimes or () if "=" not in r]
    a.rest += [r for r in a.regimes or () if "=" in r]
    if a.preset == "list":
        for name, p in [*PRESETS.items(), ("keepbest", KEEPBEST)]:
            print(f"{name}: {p.script} -> {p.workdir}/{p.results} "
                  f"(runs {', '.join(p.runs)})")
        return
    if a.preset == "compare":
        if len(a.rest) != 2:
            raise SystemExit("compare: name REF.json and RUN.json")
        print(compare_files(*a.rest))
        return
    if a.preset == "rescore":
        dirs = [r for r in a.rest if "=" not in r]
        if not dirs:
            raise SystemExit("rescore: name at least one work directory")
        over = {**parse_overrides([r for r in a.rest if "=" in r]),
                "device": a.device}
        for d in dirs:
            rescore(d, over, n_batches=a.n_batches or 16)
        return
    run_preset(a.preset, regimes, a.workdir, a.device,
               parse_overrides(a.rest), a.max_steps, a.n_batches)


if __name__ == "__main__":
    main(sys.argv[1:])
