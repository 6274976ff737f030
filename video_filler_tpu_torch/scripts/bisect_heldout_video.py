"""Where the port's held-out video ledger parts from the JAX package's: the
preset's video run (``python -m video_filler_tpu_torch.ledger heldout
--regimes video``) with some of its inputs swapped for the JAX run's, each
swap made in this process only:

  --init PATH   the training loop (and the ledger's init row) start from
                the JAX loop's initial state, a JAX checkpoint written by
                scripts/control_heldout_video_start.py, instead of the
                port's own draw of the weights (threefry against Philox);
  --draws PATH  step i's preprocess takes the JAX run's random blocks and
                flips of step i (the same script's draws file) instead of
                drawing its own;
  --plain-loss  the reconstruction term is the plain PyTorch formula
                (ops/cuda/fused_loss.py ``weighted_mse_reference``, its
                gradient by autograd) instead of the fused kernel.

    python -m video_filler_tpu_torch.scripts.bisect_heldout_video
        [--init PATH] [--draws PATH] [--plain-loss] [ledger options:
        --workdir, --device, --max-steps, --n-batches, key=value ...]

The run writes no checkpoint: its live generator is scored at init, every
``checkpointEvery`` epochs (the preset's mid checkpoint and its multiples)
and at the end (``run_ledger(save=False)``), and every row names the swaps
(``"bisect": "init+draws"``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from video_filler_tpu_torch.checkpoint import restore_checkpoint
from video_filler_tpu_torch.ledger import common
from video_filler_tpu_torch.ledger import __main__ as ledger_cli
from video_filler_tpu_torch.ops.cuda.fused_loss import weighted_mse_reference
from video_filler_tpu_torch.train import loop
from video_filler_tpu_torch.train import step as step_mod


def start_from(path: str) -> None:
    """Every ``init_train_state`` of the ledger and the loop loads the
    state at ``path`` over its own draw."""
    own = step_mod.init_train_state

    def init_train_state(opt, regime, gen, mesh=None):
        state = own(opt, regime, gen, mesh)
        restore_checkpoint(path, state)
        return state
    common.init_train_state = loop.init_train_state = init_train_state


class JaxDraws:
    """``video_draws`` from a draws file: while ``step`` is set (the loop's
    steps, see ``draws_from``), the call for step i returns row i of the
    file and moves on to i + 1; otherwise (the ledger's scoring) the
    port's own draws."""

    def __init__(self, path: str, own):
        with np.load(path) as f:
            self.rows = {k: torch.from_numpy(
                f[k].astype(bool if k == "flip" else np.int64))
                for k in f.files}
        self.own, self.step = own, None

    def __call__(self, opt, gen, raw_shape):
        i = self.step
        if i is None:
            return self.own(opt, gen, raw_shape)
        if i >= len(self.rows["flip"]):
            raise RuntimeError(f"the draws file holds {len(self.rows['flip'])}"
                               f" steps; step {i} asked for")
        self.step = i + 1
        zero = torch.zeros(raw_shape[0], dtype=torch.int64)
        return {"y0": zero, "x0": zero, "flip": self.rows["flip"][i],
                "blocks": {k: self.rows[k][i]
                           for k in ("n_blocks", "tly", "tlx")}}


def draws_from(path: str) -> JaxDraws:
    """The video preprocess of the loop's step i takes row i of the draws
    file (counted from 0 at each ``train`` call of the ledger); the
    ledger's scoring, in the loop's epoch hook too, draws its own."""
    draws = JaxDraws(path, step_mod.video_draws)
    own_train, own_score = common.train, common.score

    def train(*args, **kw):
        draws.step = 0
        try:
            return own_train(*args, **kw)
        finally:
            draws.step = None

    def score(*args, **kw):
        at, draws.step = draws.step, None
        try:
            return own_score(*args, **kw)
        finally:
            draws.step = at
    step_mod.video_draws, common.train, common.score = draws, train, score
    return draws


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m video_filler_tpu_torch.scripts.bisect_heldout_video",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--init")
    ap.add_argument("--draws")
    ap.add_argument("--plain-loss", action="store_true")
    a, rest = ap.parse_known_args(argv)
    swaps = []
    if a.init:
        start_from(os.path.abspath(a.init))
        swaps.append("init")
    if a.draws:
        draws_from(os.path.abspath(a.draws))
        swaps.append("draws")
    if a.plain_loss:
        step_mod.fused_weighted_mse = weighted_mse_reference
        swaps.append("plain_loss")
    tag = "+".join(swaps) or "none"
    print(f"bisect: the held-out video run with the JAX run's {tag} "
          "swapped in", flush=True)
    own_run_ledger = ledger_cli.run_ledger

    def run_ledger(opt, *args, extra=None, **kw):
        # scored where the preset saves; the loop itself saves nothing
        kw.update(save=False, score_every=opt.checkpointEvery)
        return own_run_ledger(opt.replace(checkpointEvery=opt.niter + 1),
                              *args, extra={**(extra or {}), "bisect": tag},
                              **kw)
    ledger_cli.run_ledger = run_ledger
    ledger_cli.main(["heldout", "--regimes", "video", *rest])


if __name__ == "__main__":
    main(sys.argv[1:])
