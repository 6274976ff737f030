"""Seed control for the held-out video ledger.

The video run of scripts/run_heldout_ledgers.py (its corpus and its video
``Opt``), with only ``manualSeed`` changed, so that the JAX package's
spread over seeds can be set beside the PyTorch port's.  That script
hard-codes seed 222 and stays as it is.

Usage: python scripts/control_heldout_video_seed.py SEED [WORKDIR]

Runs in WORKDIR (default ``ledgers/heldout3_jax_s<SEED>`` under the
current directory, so that two seeds can run side by side) and writes
``heldout_results_jax_h100_video_s<SEED>.json`` there, every row as it
lands.
"""
import os
import sys

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPTS))
sys.path.insert(0, _SCRIPTS)  # ledger_common (the script chdirs)

if len(sys.argv) not in (2, 3):
    raise SystemExit(__doc__)
SEED = int(sys.argv[1])
WORK = sys.argv[2] if len(sys.argv) > 2 else f"ledgers/heldout3_jax_s{SEED}"
os.makedirs(WORK, exist_ok=True)
os.chdir(WORK)

from video_filler_tpu.data import synthetic  # noqa: E402

# run_heldout_ledgers.py's video corpus: 4x 64-frame videos + logo mask.
if not os.path.isdir("corpus"):
    synthetic.make_video_corpus("corpus", n_videos=4, frames=64,
                                h=180, w=240)
    synthetic.make_mask_png("mask.png", h=180, w=240)
print("corpus ready", flush=True)

from ledger_common import json_flusher, run_ledger  # noqa: E402
from video_filler_tpu.config import Opt  # noqa: E402

RESULTS = []
_flush = json_flusher(f"heldout_results_jax_h100_video_s{SEED}.json",
                      RESULTS)

# run_heldout_ledgers.py's ``common`` and video Opt; manualSeed from argv.
common = dict(loadSize=150, fineSize=128, nBottleneck=4000, wtl2=0.999,
              ntrain=256, nThreads=2, manualSeed=SEED, display=False,
              logEvery=400, split=80)
opt = Opt(DATA_ROOT="corpus", maskName="mask.png", batchSize=64, predLen=2,
          weight_nomask=0.05, niter=1000, checkpointEvery=267, name="hv",
          **common)
spe = 3   # split=80 leaves 204 train frames: 3 steps/epoch at batch 64
run_ledger(opt, "video", ("train", "test"), RESULTS,
           mid_tag=f"step{opt.checkpointEvery * spe}",
           final_tag=f"step{opt.niter * spe}", flush=_flush)
print("ALL-DONE", len(RESULTS), flush=True)
