#!/bin/sh
# Eval sweep on the PyTorch port: the seeded tiled whole-frame eval of
# scripts/run_test_video.sh (the reference's runtestvid.sh:20-122 over
# seeds 24751 5079 7814 37062 4791) with the same key=value options, run
# by the port's eval.wholeim on the card.  Run from the repository root
# (the default MASK is a path under it).  Options the sweep does not set
# can come from the environment (the CLI's env shim), e.g. device=cpu.
set -e
: "${DATA_ROOT:?set DATA_ROOT to the video corpus root}"
: "${NET:?set NET to a generator checkpoint .npz}"
MASK="${MASK:-assets/masks/maskppp.png}"
SEEDS="${SEEDS:-24751 5079 7814 37062 4791}"

for seed in $SEEDS; do
  python -m video_filler_tpu_torch.eval.wholeim DATA_ROOT="$DATA_ROOT" \
    maskName="$MASK" net="$NET" loadSize="${loadSize:-240}" \
    predLen="${predLen:-4}" nBottleneck="${nBottleneck:-5000}" \
    manualSeed="$seed" name="eval_s$seed"
done
