#!/bin/sh
# Experiment recipes for the video regime on the PyTorch port: the six
# train recipes of scripts/run_train_video.sh (the reference's
# runtrainvid.sh:31-61) with the same key=value options, run by the port's
# trainer on the card.  Pass a recipe name as $1; DATA_ROOT must point at
# the frame corpus (gt/ + gt1/ numbered frames).  Run from the repository
# root (the default MASK is a path under it).  Options the recipe does
# not set can come from the environment (the trainer's env shim), e.g.
# device=cpu niter=1 ntrain=8.
set -e
: "${DATA_ROOT:?set DATA_ROOT to the video corpus root}"
MASK="${MASK:-assets/masks/maskppp.png}"
EXP="${1:-canonical}"

case "$EXP" in
  canonical)    # runtrainvid.sh:61 (0912): weight_nomask=0.5
    python -m video_filler_tpu_torch.train regime=video DATA_ROOT="$DATA_ROOT" \
      maskName="$MASK" nBottleneck=5000 name=vid_canonical loadSize=240 \
      nThreads=4 predLen=1 batchSize=64 weight_nomask=0.5 wtl2=0.999 ;;
  maskvalue0)   # "changemaskvalue": hole filled with black
    python -m video_filler_tpu_torch.train regime=video DATA_ROOT="$DATA_ROOT" \
      maskName="$MASK" nBottleneck=4000 name=vid_maskvalue0 loadSize=360 \
      nThreads=4 predLen=1 batchSize=64 weight_nomask=1 maskValue=0 \
      wtl2=0.999 ;;
  finetune)     # resume semantics (loadName/loadIter)
    python -m video_filler_tpu_torch.train regime=video DATA_ROOT="$DATA_ROOT" \
      maskName="$MASK" nBottleneck=4000 name=vid_maskvalue0 loadSize=360 \
      loadName=vid_maskvalue0 loadIter=40 nThreads=4 predLen=1 \
      batchSize=64 weight_nomask=1 wtl2=0.999 ;;
  l2gdl)        # NOTE: flagged "!!Diverges" in the reference ledger
    python -m video_filler_tpu_torch.train regime=video DATA_ROOT="$DATA_ROOT" \
      maskName="$MASK" nBottleneck=5000 name=vid_l2gdl loadSize=240 \
      nThreads=4 predLen=1 batchSize=64 weight_nomask=0.05 wtl2=1 \
      wtgdl=0.5 ;;
  init)         # initializer cascade (withInit/initName)
    : "${INIT_NET:?set INIT_NET to a pretrained checkpoint .npz}"
    python -m video_filler_tpu_torch.train regime=video DATA_ROOT="$DATA_ROOT" \
      maskName="$MASK" nBottleneck=5000 name=vid_init loadSize=280 \
      nThreads=4 predLen=1 batchSize=64 lr=0.0001 weight_nomask=1 \
      wtl2=0.999 withInit=1 initName="$INIT_NET" ;;
  wholeim)      # train_wholeim_input.lua regime
    python -m video_filler_tpu_torch.train regime=wholeim DATA_ROOT="$DATA_ROOT" \
      maskName="$MASK" name=wholeim loadSize=360 batchSize=32 \
      nBottleneck=6400 nef=192 ngf=192 ndf=128 wtl2=0.999 \
      checkpointEvery=2 ;;
  *) echo "unknown experiment '$EXP'" >&2; exit 2 ;;
esac
