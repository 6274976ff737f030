"""Epoch driver + CLI for the port (counterpart of
video_filler_tpu/train/loop.py).

Single process, one device.  Each step: a uint8 batch from the threaded
host pipeline is copied to the device, preprocessed there with decisions
drawn from a per-step ``torch.Generator`` (seeded by the JAX loop's per-step
formula), and run through the train step.  Metrics go to stdout and JSONL in
the reference format (utils/logger.py of the JAX package), one step late so
that reading them does not stall the device; display grids go to PNGs.

CLI (env-var names match the reference; see config.py):
    python -m video_filler_tpu_torch.train regime=center DATA_ROOT=/data \\
        device=cuda batchSize=64 wtl2=0.999 overlapPred=4 checkpointEvery=100

Options the port does not run yet exit with the ROADMAP item that brings
them (``unsupported_options``); that includes checkpoints, so a run needs
``checkpointEvery`` above ``niter``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from video_filler_tpu.utils import MetricsLogger, save_image_grid
from video_filler_tpu_torch.config import (
    REGIMES,
    Opt,
    from_args,
    resolve_device,
    split_regime,
)
from video_filler_tpu_torch.data.pipeline import DataLoader, make_sampler
from video_filler_tpu_torch.models import specs_for_regime
from video_filler_tpu_torch.ops import masks
from video_filler_tpu_torch.train.step import (
    init_train_state,
    make_preprocess,
    make_train_step,
    unsupported_step_options,
)


def unsupported_options(opt: Opt, regime: str) -> list[str]:
    """Every requested option the port cannot run yet, each naming the
    ROADMAP item that brings it."""
    out = []
    try:
        specs_for_regime(opt, regime)
    except NotImplementedError as e:  # regime, conditionAdv, noiseGen, ...
        out.append(str(e))
    checks = (
        (opt.dataDevice, "dataDevice (ROADMAP A.10)"),
        (opt.seqParallel > 1 or opt.modelParallel > 1 or opt.dataParallel > 1,
         "seqParallel/modelParallel/dataParallel>1 (ROADMAP A.14)"),
        (opt.withInit, "withInit (ROADMAP A.7)"),
        (opt.autoResume, "autoResume (ROADMAP A.6)"),
        (opt.loadName, "loadName (ROADMAP A.6)"),
        (opt.evalEvery > 0, "evalEvery (ROADMAP A.9)"),
        (opt.keepBest, "keepBest (ROADMAP A.9)"),
        (opt.displayServer, "displayServer (ROADMAP A.9)"),
        (opt.profileSteps > 0, "profileSteps (ROADMAP A.9)"),
    )
    out += [f"{what} is not ported yet" for bad, what in checks if bad]
    out += unsupported_step_options(opt)
    if opt.checkpointEvery <= opt.niter:
        out.append(f"checkpoints are not ported yet (ROADMAP A.6): set "
                   f"checkpointEvery above niter ({opt.niter})")
    return out


def _display_dump(opt: Opt, batch, fake, out_dir: str, epoch: int,
                  step: int) -> None:
    """PNG grids of fake / real / composited (train.lua:427-445 analogue)."""
    tag = f"{opt.name}_e{epoch}_s{step}"
    real = batch["real"]
    comp = masks.paste_center(masks.center_mask_fill(real, opt.overlapPred),
                              fake, opt.overlapPred)
    nc = opt.nc
    for suffix, img in (("fake", fake), ("real", real), ("inpaint", comp)):
        save_image_grid(f"{out_dir}/{tag}_{suffix}.png",
                        img.float().cpu().numpy()[..., :nc])


def train(opt: Opt, regime: str):
    """Run the training loop; returns the final TrainState."""
    if regime not in REGIMES:
        raise SystemExit(f"unknown regime {regime!r}; expected one of "
                         f"{', '.join(REGIMES)}")
    bad = unsupported_options(opt, regime)
    if bad:
        raise SystemExit("; ".join(bad))
    device = resolve_device(opt)
    seed = opt.manualSeed or int(np.random.randint(1, 10000))
    print(f"Seed: {seed}")
    sampler, ds_size = make_sampler(opt, regime)
    state = init_train_state(opt, regime, torch.Generator().manual_seed(seed))
    if device.type == "cuda":
        # Shapes are fixed across steps: let cuDNN time its algorithms once.
        torch.backends.cudnn.benchmark = True
    preprocess = make_preprocess(opt, regime)
    step_fn = make_train_step(opt, regime)
    display_gen = torch.Generator().manual_seed(seed + 1)

    loader = DataLoader(sampler, opt.nThreads, seed=seed,
                        prefetch_depth=opt.prefetchDepth)
    logger = MetricsLogger(opt.name)
    ntrain = min(ds_size, opt.ntrain)
    steps_per_epoch = max(int(ntrain // opt.batchSize), 1)
    done = 0
    pending_log = None

    def to_device(host_batch):
        return {"raw": torch.from_numpy(host_batch["raw"]).to(device)}

    def flush_log():
        nonlocal pending_log
        if pending_log is None:
            return
        epoch_, step_, total, metrics, t_step, t_data = pending_log
        pending_log = None
        host = {k: v.item() for k, v in metrics.items()}
        if opt.haltOnNonFinite:
            bad = [k for k, v in host.items() if not np.isfinite(v)]
            if bad:
                raise RuntimeError(
                    f"non-finite loss {bad} at epoch {epoch_} step {step_} — "
                    f"training diverged (lower lr, or set haltOnNonFinite=0 "
                    f"to push through)")
        logger.log_step(epoch_, step_, total, host, t_step, t_data)

    try:
        for epoch in range(1, opt.niter + 1):
            t_epoch = time.perf_counter()
            for step in range(steps_per_epoch):
                t0 = time.perf_counter()
                host_batch = loader.get_batch()
                t_data = time.perf_counter() - t0
                step_seed = (seed * 1_000_003 + done) % 2**31
                batch = preprocess(to_device(host_batch),
                                   torch.Generator().manual_seed(step_seed))
                metrics = step_fn(state, batch)
                if opt.display and (step + 1) % opt.display_iter == 0:
                    # The reference runs an extra batch through G every
                    # display_iter steps (train.lua:427-445).
                    shown = preprocess(to_device(loader.get_batch()),
                                       display_gen)
                    ctx = masks.center_mask_fill(shown["real"],
                                                 opt.overlapPred)
                    with torch.no_grad():
                        fake = state.gen.eval()(ctx)
                    _display_dump(opt, shown, fake, "display", epoch,
                                  step + 1)
                flush_log()
                if step % opt.logEvery == 0:
                    pending_log = (epoch, step, steps_per_epoch, metrics,
                                   time.perf_counter() - t0, t_data)
                done += 1
            flush_log()
            logger.log_epoch(epoch, opt.niter, time.perf_counter() - t_epoch)
    finally:
        loader.close()
        logger.close()
    return state


def main(argv: list[str]):
    regime, rest = split_regime(argv)
    return train(from_args(rest), regime)


if __name__ == "__main__":
    main(sys.argv[1:])
