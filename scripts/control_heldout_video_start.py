"""What the JAX package's held-out video run starts from, written to files
for another implementation to start from the same place.

The video run of scripts/run_heldout_ledgers.py (with ``manualSeed`` from
argv) seeds its training loop from PRNGKey(seed): the loop's initial
TrainState comes from the second half of its first split
(video_filler_tpu/train/loop.py ``key, k_init = split(key)``), and step i
of the run preprocesses its batch with the first half of
split(PRNGKey((seed * 1000003 + i) % 2**31)) (loop.py ``step_seed``).  The
video preprocess (train/step.py ``make_preprocess``) splits that key into
crop, random-block and flip keys; the host sampler already crops to
fineSize, so only the random blocks (ops/masks.py ``random_block_mask``)
and the flips are drawn.

Usage: python scripts/control_heldout_video_start.py SEED OUT_DIR [STEPS]
           [key=value ...]

``key=value`` options go over the run's Opt (the widths of a small test).

Writes OUT_DIR/jax_video_s<SEED>_init_0_state.npz (the loop's initial
TrainState, the JAX checkpoint format) and OUT_DIR/jax_video_s<SEED>_draws.npz
(``flip`` (STEPS, B) bool, ``n_blocks`` (STEPS, B), ``tly`` and ``tlx``
(STEPS, B, 10) int32; STEPS defaults to 3000).
"""
import os
import sys

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPTS))

ARGS = [a for a in sys.argv[1:] if "=" not in a]
if len(ARGS) not in (2, 3):
    raise SystemExit(__doc__)
SEED, OUT = int(ARGS[0]), ARGS[1]
STEPS = int(ARGS[2]) if len(ARGS) > 2 else 3000

import jax  # noqa: E402
import numpy as np  # noqa: E402

from video_filler_tpu.checkpoint import save_checkpoint  # noqa: E402
from video_filler_tpu.config import Opt, from_args  # noqa: E402
from video_filler_tpu.train.step import init_train_state  # noqa: E402

# run_heldout_ledgers.py's video Opt (the data options do not change the
# state or the draws)
opt = Opt(DATA_ROOT="corpus", maskName="mask.png", batchSize=64, predLen=2,
          weight_nomask=0.05, niter=1000, checkpointEvery=267, name="hv",
          loadSize=150, fineSize=128, nBottleneck=4000, wtl2=0.999,
          ntrain=256, nThreads=2, manualSeed=SEED, display=False,
          logEvery=400, split=80)
opt = from_args([a for a in sys.argv[1:] if "=" in a], opt)
os.makedirs(OUT, exist_ok=True)
_, k_init = jax.random.split(jax.random.PRNGKey(SEED))
path = save_checkpoint(OUT, f"jax_video_s{SEED}_init", 0,
                       jax.device_get(init_train_state(k_init, opt, "video")))
print("initial state:", path, flush=True)

B, FS, MAX_BLOCKS = opt.batchSize, opt.fineSize, 10
BS = FS // 6


def draws(step_seed):
    k1, _ = jax.random.split(jax.random.PRNGKey(step_seed))
    _, k_blk, k_flip = jax.random.split(k1, 3)
    k_n, k_y, k_x = jax.random.split(k_blk, 3)
    return {"flip": jax.random.uniform(k_flip, (B,)) < 0.5,
            "n_blocks": jax.random.randint(k_n, (B,), 2, MAX_BLOCKS + 1),
            "tly": jax.random.randint(k_y, (B, MAX_BLOCKS), 2, FS - BS - 2),
            "tlx": jax.random.randint(k_x, (B, MAX_BLOCKS), 2, FS - BS - 2)}


seeds = ((np.int64(SEED) * 1_000_003 + np.arange(STEPS, dtype=np.int64))
         % np.int64(2**31)).astype(np.int32)
out = jax.device_get(jax.jit(jax.vmap(draws))(seeds))
dpath = os.path.join(OUT, f"jax_video_s{SEED}_draws.npz")
np.savez(dpath, **{k: np.asarray(v) for k, v in out.items()})
print("draws:", dpath, {k: v.shape for k, v in out.items()}, flush=True)
