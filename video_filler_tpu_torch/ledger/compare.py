"""Two ledgers' rows side by side: a reference run's (the JAX package's
result file) and another's (the port's on the card), matched by
(regime, ckpt, evalSplit), with the difference in hole-L2 as a share of
the reference's value and in PSNR.

The two packages draw from different random streams (threefry against
Philox), so curves agree in distribution, not number for number; the
limits are statistical: at the final checkpoint hole-L2 within 20% and
PSNR within 1.0 dB, at init hole-L2 within 10%.  Mid rows have no limit.

    python -m video_filler_tpu_torch.ledger compare REF.json RUN.json
"""

from __future__ import annotations

import json

__all__ = ["FINAL_HOLE_L2", "FINAL_PSNR_DB", "INIT_HOLE_L2", "align_tags",
           "compare", "markdown"]

FINAL_HOLE_L2 = 0.20     # |d hole_l2| / reference, final rows
FINAL_PSNR_DB = 1.0      # |d psnr_db|, final rows
INIT_HOLE_L2 = 0.10      # |d hole_l2| / reference, init rows


def _key(r: dict) -> tuple:
    return r["regime"], r["ckpt"], r["evalSplit"]


def compare(ref: list[dict], rows: list[dict], final_tags: dict) -> list:
    """One entry per row of ``rows`` that ``ref`` holds too, in ``rows``'
    order: (reference row, row, hole-L2 share, PSNR difference, verdict).
    ``final_tags``: regime -> the tag of its final checkpoint.  The
    verdict is "ok", "miss" or "" (a mid row)."""
    by_key = {_key(r): r for r in ref}
    out = []
    for r in rows:
        j = by_key.get(_key(r))
        if j is None:
            continue
        share = (r["hole_l2"] - j["hole_l2"]) / j["hole_l2"]
        d_psnr = r["psnr_db"] - j["psnr_db"]
        if r["ckpt"] == "init":
            verdict = "ok" if abs(share) <= INIT_HOLE_L2 else "miss"
        elif r["ckpt"] == final_tags.get(r["regime"]):
            verdict = ("ok" if abs(share) <= FINAL_HOLE_L2
                       and abs(d_psnr) <= FINAL_PSNR_DB else "miss")
        else:
            verdict = ""
        out.append((j, r, share, d_psnr, verdict))
    return out


def _hole_l2(r: dict) -> str:
    """hole-L2 ± its std; rows scored before the std columns existed (the
    JAX package's round-3 files) have none."""
    std = r.get("hole_l2_std")
    return f"{r['hole_l2']:.4f}" + ("" if std is None else f" ± {std:.4f}")


def markdown(entries: list) -> str:
    """The comparison as a Markdown table; "options" names a row's keys
    beyond the reference row's (a run's departures from its preset, such
    as ``manualSeed``), std columns aside."""
    lines = ["| regime | ckpt | split | options | ref hole_l2 | hole_l2 "
             "| d hole_l2 | ref PSNR dB | PSNR dB | d PSNR dB | limit |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for j, r, share, d_psnr, verdict in entries:
        options = " ".join(f"{k}={v}" for k, v in r.items()
                           if k not in j and not k.endswith("_std"))
        lines.append(
            f"| {r['regime']} | {r['ckpt']} | {r['evalSplit']} | {options} "
            f"| {_hole_l2(j)} | {_hole_l2(r)} "
            f"| {100 * share:+.1f}% "
            f"| {j['psnr_db']:.2f} | {r['psnr_db']:.2f} | {d_psnr:+.2f} "
            f"| {verdict} |")
    return "\n".join(lines)


def _tags(rows: list[dict], regime: str) -> list[str]:
    return list(dict.fromkeys(r["ckpt"] for r in rows
                              if r["regime"] == regime))


def align_tags(ref: list[dict], rows: list[dict]) -> list[dict]:
    """``rows`` with a regime's checkpoint tags renamed to the reference's
    by position (init, mid, final) where the two files hold as many tags
    for it but name them differently (the JAX scripts' ``mid`` and
    ``final`` against the step reached, ``step3000``); a renamed row keeps
    its own tag as ``run_ckpt``."""
    out = []
    for r in rows:
        mine, theirs = _tags(rows, r["regime"]), _tags(ref, r["regime"])
        if len(mine) == len(theirs) and mine != theirs:
            tag = theirs[mine.index(r["ckpt"])]
            if tag != r["ckpt"]:
                r = {**r, "ckpt": tag, "run_ckpt": r["ckpt"]}
        out.append(r)
    return out


def compare_files(ref_path: str, path: str) -> str:
    """The Markdown table of two result files, their tags aligned
    (``align_tags``); a regime's final tag is the last tag its rows in
    ``path`` hold."""
    with open(ref_path) as f:
        ref = json.load(f)
    with open(path) as f:
        rows = align_tags(ref, json.load(f))
    final_tags = {r["regime"]: r["ckpt"] for r in rows}
    return markdown(compare(ref, rows, final_tags))
