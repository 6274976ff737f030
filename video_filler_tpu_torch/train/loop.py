"""Epoch driver + CLI for the port (counterpart of
video_filler_tpu/train/loop.py).

Single process, one device.  Each step: a uint8 batch from the threaded
host pipeline is copied to the device, preprocessed there with decisions
drawn from a per-step ``torch.Generator`` (seeded by the JAX loop's per-step
formula), and run through the train step.  Metrics go to stdout and JSONL in
the reference format (utils/logger.py of the JAX package), one step late so
that reading them does not stall the device; display grids go to PNGs.

Checkpoints are the JAX package's files (checkpoint/ckpt.py): saved every
``checkpointEvery`` epochs (pruned to ``keepCheckpoints`` before each save,
written on a background thread), on SIGTERM at the next step boundary, and
restored by ``autoResume`` or ``loadName``+``loadIter``.  ``withInit`` with
``initName`` runs a checkpoint's generator ahead of G (video, video3d).

CLI (env-var names match the reference; see config.py):
    python -m video_filler_tpu_torch.train regime=video DATA_ROOT=/data \\
        device=cuda batchSize=64 wtl2=0.999 weight_nomask=0.05 \\
        maskName=maskppp.png predLen=4 nBottleneck=4000

``evalEvery=N`` scores the live generator every N epochs on ``evalSplit``
(eval/metrics.evaluate); with ``keepBest`` each improvement of
``bestMetric`` rewrites ``<name>_best_state.npz``, a G-only file that the
eval CLIs and the server read like any checkpoint, and whose meta carries
the best value across ``autoResume``.

Options the port does not run yet exit with the ROADMAP item that brings
them (``unsupported_options``).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from video_filler_tpu_torch.checkpoint import (
    checkpoint_path,
    prune_checkpoints,
    read_meta,
    restore_checkpoint,
    restore_latest,
    restore_subtree,
    save_checkpoint,
    wait_pending_saves,
)
from video_filler_tpu_torch.config import (
    REGIMES,
    Opt,
    from_args,
    resolve_device,
    split_regime,
)
from video_filler_tpu_torch.data.pipeline import DataLoader, make_sampler
from video_filler_tpu_torch.eval.common import live_generator
from video_filler_tpu_torch.eval.metrics import evaluate
from video_filler_tpu_torch.models import (
    build_generator,
    check_fine_size,
    specs_for_regime,
)
from video_filler_tpu_torch.ops import masks
from video_filler_tpu_torch.train.step import (
    check_condition_adv,
    draw_noise,
    init_train_state,
    make_preprocess,
    make_train_step,
)
from video_filler_tpu_torch.utils import MetricsLogger, save_image_grid

# The metrics eval/metrics.evaluate reports that keepBest can monitor;
# PSNR and SSIM improve upwards, the L2s downwards.
_EVAL_METRICS = {"l2", "psnr_db", "ssim", "hole_l2"}
_HIGHER_BETTER = {"psnr_db", "ssim"}


def unsupported_options(opt: Opt, regime: str) -> list[str]:
    """Every requested option the port cannot run yet, each naming the
    ROADMAP item that brings it, and every option the regime refuses."""
    out = []
    try:
        specs_for_regime(opt, regime)      # noiseGen/conditionAdv on video3d
        check_fine_size(opt, regime)       # video3d
        check_condition_adv(opt, regime)   # center only
    except (NotImplementedError, ValueError) as e:
        out.append(str(e))
    checks = (
        (opt.dataDevice, "dataDevice (ROADMAP A.10)"),
        (opt.seqParallel > 1 or opt.modelParallel > 1 or opt.dataParallel > 1,
         "seqParallel/modelParallel/dataParallel>1 (ROADMAP A.14)"),
        (opt.displayServer, "displayServer (ROADMAP A.9)"),
        (opt.profileSteps > 0, "profileSteps (ROADMAP A.9)"),
    )
    out += [f"{what} is not ported yet" for bad, what in checks if bad]
    return out


def check_eval_options(opt: Opt, regime: str) -> None:
    """evalEvery / keepBest preflight, before any resource exists: a bad
    combination must stop the run at its start, not at the first eval."""
    if opt.evalEvery > 0:
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise SystemExit(
                "evalEvery is single-process: in-train eval draws from a "
                "host-local sampler -- run eval.metrics on saved "
                "checkpoints instead")
        # The video and logo samplers raise on evalSplit=test with
        # split=100 themselves; a folder's test portion can be empty.
        if not make_sampler(opt, regime, split=opt.evalSplit)[1]:
            raise SystemExit(
                f"evalEvery: evalSplit={opt.evalSplit!r} selects an empty "
                f"dataset portion (split={opt.split}) -- use split < 100 "
                "to reserve a held-out portion")
    if opt.keepBest:
        if opt.evalEvery <= 0:
            raise SystemExit("keepBest=1 needs evalEvery=N (>0): the "
                             "best-so-far test runs at each in-train eval")
        if opt.bestMetric not in _EVAL_METRICS:
            raise SystemExit(
                f"bestMetric={opt.bestMetric!r} is not an eval metric; "
                f"expected one of {sorted(_EVAL_METRICS)}")


def step_seed(seed: int, global_step: int) -> int:
    """The per-step seed of the preprocess decisions: a function of the
    run's seed and the global step, so a resumed run continues the
    uninterrupted run's sequence (the JAX loop's formula, loop.py:582)."""
    return (seed * 1_000_003 + global_step) % 2**31


def generator_input(opt: Opt, regime: str, batch) -> torch.Tensor:
    """G's input for a preprocessed batch: the center-filled image, the
    logo-masked clip, or the regime's own masked input."""
    if "masked" in batch:
        return batch["masked"]
    if regime == "center":
        return masks.center_mask_fill(batch["real"], opt.overlapPred)
    return masks.apply_logo_mask(batch["real"], batch["mask"], opt.maskValue)


def _display_dump(opt: Opt, regime: str, batch, fake, out_dir: str,
                  epoch: int, step: int) -> None:
    """PNG grids of fake / real / composited (train.lua:427-445 analogue)."""
    tag = f"{opt.name}_e{epoch}_s{step}"
    real = batch["real"]
    if real.dim() == 5:  # a video3d clip: show the first frame
        batch = {k: v[:, 0] for k, v in batch.items()}
        real, fake = batch["real"], fake[:, 0]
    if regime == "center":
        ctx = masks.center_mask_fill(real, opt.overlapPred)
        comp = masks.paste_center(ctx, fake, opt.overlapPred)
    elif "mask" in batch:
        comp = masks.fill_in(real, batch["mask"], fake)
    else:
        comp = fake
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
    with_init = bool(opt.withInit and opt.initName)
    if with_init and regime not in ("video", "video3d"):
        raise SystemExit(f"withInit requires regime=video or video3d, not "
                         f"{regime!r}")
    check_eval_options(opt, regime)
    device = resolve_device(opt)
    seed = opt.manualSeed or int(np.random.randint(1, 10000))
    print(f"Seed: {seed}")
    sampler, ds_size = make_sampler(opt, regime)
    state = init_train_state(opt, regime, torch.Generator().manual_seed(seed))

    start_epoch = 1
    if opt.autoResume:
        # Restart from wherever the last run checkpointed (the reference's
        # only recovery is manual loadName/loadIter,
        # train_vid_weighted.lua:242-257).
        found = restore_latest(opt.checkpointDir, opt.name, state)
        if found is not None:
            start_epoch = found[1] + 1
            print(f"auto-resumed {opt.name} at epoch {found[1]}")
    elif opt.loadName and opt.loadIter:
        path = checkpoint_path(opt.checkpointDir, opt.loadName, opt.loadIter)
        restore_checkpoint(path, state)
        start_epoch = opt.loadIter + 1
        print(f"Resumed {path} at epoch {opt.loadIter}")

    init_net = None
    if with_init:
        # The initializer cascade: a pre-trained generator run ahead of G
        # (train_mycrit.lua:261-265,402-405).  G only: the file's D and
        # optimizer shapes need not match this run's.
        init_net = restore_subtree(
            opt.initName, build_generator(specs_for_regime(opt, regime)[0],
                                          torch.Generator().manual_seed(0)))
        init_net = init_net.to(device).eval().requires_grad_(False)

    if device.type == "cuda":
        # Shapes are fixed across steps: let cuDNN time its algorithms once.
        torch.backends.cudnn.benchmark = True
    best = None
    best_path = checkpoint_path(opt.checkpointDir, opt.name, "best")
    if opt.keepBest and os.path.exists(best_path):
        # An autoResume'd run keeps the best so far: its first eval must not
        # overwrite a better earlier peak.  A file banked under another
        # metric holds no comparable value; the first eval re-banks.
        meta = read_meta(best_path)
        if opt.bestMetric in meta:
            best = float(meta[opt.bestMetric])
            print(f"keepBest: resuming best-so-far {opt.bestMetric}="
                  f"{best:.4g} from {best_path}")

    preprocess = make_preprocess(opt, regime)
    step_fn = make_train_step(opt, regime, with_init=with_init)
    display_gen = torch.Generator().manual_seed(seed + 1)

    # Resume continuity: the restored global step is folded into both
    # random streams.  The step seeds continue the interrupted run's; the
    # loader, whose stream cannot be fast-forwarded, draws a fresh one
    # rather than replaying the run's first batches (JAX loop.py:283-338).
    step0 = state.step
    loader = DataLoader(sampler, opt.nThreads, seed=seed + 104729 * step0,
                        prefetch_depth=opt.prefetchDepth)
    logger = MetricsLogger(opt.name)
    ntrain = min(ds_size, opt.ntrain)
    steps_per_epoch = max(int(ntrain // opt.batchSize), 1)
    done = 0
    pending_log = None

    def to_device(host_batch):
        return {k: torch.from_numpy(v).to(device)
                for k, v in host_batch.items()}

    def eval_event(epoch: int, best: float | None) -> float | None:
        """Score the live G on evalSplit, log it; with keepBest, rewrite the
        best file (synchronously: successive bests share one path) when
        bestMetric improves.  Returns the best value so far."""
        with live_generator(opt, regime, state) as g:
            m = evaluate(opt.replace(net="(live)"), regime,
                         n_batches=opt.evalBatches, loaded=g)
        logger.log_eval(epoch, opt.evalSplit, m)
        if not opt.keepBest:
            return best
        val = float(m[opt.bestMetric])
        if best is not None and not (val > best
                                     if opt.bestMetric in _HIGHER_BETTER
                                     else val < best):
            return best
        p = save_checkpoint(opt.checkpointDir, opt.name, "best", state,
                            meta={"step": state.step, "epoch": epoch,
                                  "split": opt.evalSplit,
                                  opt.bestMetric: val},
                            generator_only=True)
        print(f"keepBest: {opt.bestMetric}={val:.4g} @epoch {epoch} -> {p}")
        return val

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
                    f"non-finite loss {bad} at epoch {epoch_} step {step_} "
                    f"— training diverged (resume from the last checkpoint "
                    f"in {opt.checkpointDir!r} with a lower lr, or set "
                    f"haltOnNonFinite=0 to push through)")
        logger.log_step(epoch_, step_, total, host, t_step, t_data)

    # SIGTERM (preemption): finish the step in flight, checkpoint, exit
    # cleanly.  The handler only sets a flag; the work happens at the next
    # step boundary on the main thread.
    preempted = threading.Event()
    old_sigterm = None
    if threading.current_thread() is threading.main_thread():
        old_sigterm = signal.signal(signal.SIGTERM,
                                    lambda signum, frame: preempted.set())

    try:
        for epoch in range(start_epoch, opt.niter + 1):
            t_epoch = time.perf_counter()
            for step in range(steps_per_epoch):
                t0 = time.perf_counter()
                host_batch = loader.get_batch()
                t_data = time.perf_counter() - t0
                gen = torch.Generator().manual_seed(
                    step_seed(seed, step0 + done))
                batch = preprocess(to_device(host_batch), gen)
                # a noiseGen step draws its z from the step's generator
                metrics = step_fn(state, batch, init_net,
                                  **({"gen": gen} if opt.noiseGen else {}))
                if opt.display and (step + 1) % opt.display_iter == 0:
                    # The reference runs an extra batch through G every
                    # display_iter steps (train.lua:427-445); a noiseGen G
                    # gets z drawn as the step draws it (noisetype).
                    shown = preprocess(to_device(loader.get_batch()),
                                       display_gen)
                    g_in = generator_input(opt, regime, shown)
                    with torch.no_grad():
                        if init_net is not None:
                            g_in = masks.fill_in(g_in, shown["mask"],
                                                 init_net(g_in))
                        if opt.noiseGen:
                            g_in = (g_in, draw_noise(opt, display_gen,
                                                     g_in.shape[0], device))
                        fake = state.gen.eval()(g_in)
                    _display_dump(opt, regime, shown, fake, "display", epoch,
                                  step + 1)
                flush_log()
                if step % opt.logEvery == 0:
                    pending_log = (epoch, step, steps_per_epoch, metrics,
                                   time.perf_counter() - t0, t_data)
                done += 1
                if preempted.is_set():
                    # Saved under the interrupted epoch: resume skips its
                    # remainder, which the random samplers make benign.
                    flush_log()
                    prune_checkpoints(opt.checkpointDir, opt.name,
                                      opt.keepCheckpoints)
                    p = save_checkpoint(
                        opt.checkpointDir, opt.name, epoch, state,
                        meta={"epoch": epoch, "regime": regime, "seed": seed,
                              "preempted_at_step": step0 + done})
                    print(f"SIGTERM: checkpointed {p} at epoch {epoch} "
                          f"step {done}; exiting cleanly")
                    return state
            flush_log()
            logger.log_epoch(epoch, opt.niter, time.perf_counter() - t_epoch)
            if opt.evalEvery > 0 and epoch % opt.evalEvery == 0:
                best = eval_event(epoch, best)
            if epoch % opt.checkpointEvery == 0:
                # Prune BEFORE saving: `keep` finished checkpoints stay on
                # disk even if the incoming async write fails.
                prune_checkpoints(opt.checkpointDir, opt.name,
                                  opt.keepCheckpoints)
                p = save_checkpoint(opt.checkpointDir, opt.name, epoch, state,
                                    meta={"epoch": epoch, "regime": regime,
                                          "seed": seed},
                                    async_write=True)
                print(f"checkpoint: {p}")
    finally:
        # A failure in this teardown (a failed async write, divergence
        # caught at the last flush) is raised after it, and never in place
        # of an exception already on its way out of the loop.
        propagating = sys.exc_info()[0] is not None
        deferred = None
        for cleanup in (flush_log, loader.close, logger.close,
                        wait_pending_saves):
            try:
                cleanup()
            except Exception as e:  # noqa: BLE001 -- re-raised below
                if not propagating and deferred is None:
                    deferred = e
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
        if deferred is not None:
            raise deferred
    return state


def main(argv: list[str]):
    regime, rest = split_regime(argv)
    return train(from_args(rest), regime)


if __name__ == "__main__":
    main(sys.argv[1:])
