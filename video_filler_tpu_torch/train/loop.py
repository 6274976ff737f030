"""Epoch driver + CLI for the port (counterpart of
video_filler_tpu/train/loop.py).

Single process, one device.  Each step: a uint8 batch from the threaded
host pipeline is copied to the device, preprocessed there with decisions
drawn from a per-step ``torch.Generator`` (seeded by the JAX loop's per-step
formula), and run through the train step.  Metrics go to stdout and JSONL
in the reference format (utils/logger.py of the JAX package), one step late
so that reading them does not stall the device; display grids go to PNGs.

With ``dataDevice=1`` the train split is resident on the device instead
(data/device_data.py) and each step's batch is synthesised there from a
generator on the device seeded by ``data_seed`` -- a stream apart from the
preprocess decisions', as the JAX loop splits ``kd`` from ``k1`` -- so the
batch is a pure function of (seed, global step) on a given device type, and
an ``autoResume``'d run replays the uninterrupted run's batches.  CPU and
CUDA generators give different streams, as threefry and Philox do across
the packages.

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

``displayServer=1`` serves the run's JSONL metrics and display PNGs over
HTTP on ``display_port`` (utils/dashboard.py) while it trains.
``profileSteps=N`` records a ``torch.profiler`` trace (CPU, and CUDA on
the card) of steps [5, 5+N) of the run into one Chrome trace under
``profileDir``; a run that ends inside the window stops it at its end.

Multi-process (one process per card, started by ``torchrun``): ``main``
joins the world first (parallel/distributed.py ``initialize``), then every
rank runs ``train`` on a mesh that covers the world -- ('data','model'),
or ('data','seq') with ``seqParallel`` (parallel/mesh.py, temporal.py).
Each data rank's loader draws its rows of the global batch from a stream
seeded by its data rank (the model or seq ranks of one data group see the
same rows; seq ranks then take their own frames), and the preprocess
decisions and noiseGen's z are drawn for the global batch, each data rank
taking its rows.  Rank 0 alone writes checkpoints, in the single-device
layout (a sharded bottleneck is gathered first), and the logs; the other
ranks log to ``{name}_p{rank}``.  A resume that differs between ranks
exits on every rank; ``evalEvery`` is refused and ``display`` disabled
for more than one process, and SIGTERM is handled for one process only.

    torchrun --standalone --nproc_per_node=8 -m video_filler_tpu_torch.train \
        regime=video DATA_ROOT=/data batchSize=64 [modelParallel=2]

Options a regime refuses exit naming the option (``unsupported_options``).
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time
import zlib

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
from video_filler_tpu_torch.data import device_data
from video_filler_tpu_torch.data.pipeline import DataLoader, make_sampler
from video_filler_tpu_torch.eval.common import live_generator
from video_filler_tpu_torch.eval.metrics import evaluate
from video_filler_tpu_torch.models import (
    build_generator,
    check_fine_size,
    check_seq_parallel,
    specs_for_regime,
)
from video_filler_tpu_torch.ops import masks
from video_filler_tpu_torch.parallel import comm, distributed
from video_filler_tpu_torch.parallel.mesh import (
    coords,
    make_mesh,
    mesh_shape,
    unsharded,
)
from video_filler_tpu_torch.train.step import (
    check_condition_adv,
    draw_noise,
    global_draws,
    init_train_state,
    make_preprocess,
    make_train_step,
)
from video_filler_tpu_torch.utils import (
    Dashboard,
    MetricsLogger,
    save_image_grid,
)

# The metrics eval/metrics.evaluate reports that keepBest can monitor;
# PSNR and SSIM improve upwards, the L2s downwards.
_EVAL_METRICS = {"l2", "psnr_db", "ssim", "hole_l2"}
_HIGHER_BETTER = {"psnr_db", "ssim"}


def unsupported_options(opt: Opt, regime: str) -> list[str]:
    """Every requested option the regime refuses, each in the JAX
    package's words."""
    out = []
    try:
        specs_for_regime(opt, regime)      # noiseGen/conditionAdv on video3d
        check_fine_size(opt, regime)       # video3d
        check_condition_adv(opt, regime)   # center only
        check_seq_parallel(opt, regime)    # video3d, dividing predLen
    except ValueError as e:
        out.append(str(e))
    return out


def mesh_plan(opt: Opt, world: int) -> tuple[str, int, int]:
    """(second axis, n_data, its size) of the run's mesh over ``world``
    processes: ('seq', n_data, seqParallel) with seqParallel > 1, else
    ('model', n_data, modelParallel); dataParallel=0 means all the
    remaining processes.  A mesh that does not cover the world, or a data
    axis that does not divide the batch, exits naming the sizes (the JAX
    loop falls back to fewer devices; here an idle rank would block every
    collective)."""
    axis, n_shard = (("seq", opt.seqParallel) if opt.seqParallel > 1
                     else ("model", opt.modelParallel))
    try:
        n_data, _ = mesh_shape(opt.dataParallel or None, n_shard, world,
                               axis)
    except ValueError as e:
        raise SystemExit(f"{axis}Parallel={n_shard}, dataParallel="
                         f"{opt.dataParallel}: {e}") from None
    if opt.batchSize % n_data:
        raise SystemExit(
            f"batchSize {opt.batchSize} must divide by the data axis "
            f"{n_data} (set dataParallel to a divisor of the batch)")
    return axis, n_data, n_shard


def check_data_device(opt: Opt, regime: str) -> None:
    """dataDevice preflight, before any resource exists, with the JAX
    package's words (video_filler_tpu/train/loop.py:162-176 and
    data/device_data.py:72-82): batches are synthesised on the device, so
    whatever consumes the HOST batch stream is refused, and so is a
    random-scale loadSize."""
    device_data.check_regime(opt, regime)
    if opt.seqParallel > 1:
        raise SystemExit("dataDevice does not support seqParallel")
    if opt.display:
        raise SystemExit(
            "dataDevice=1 is incompatible with display=1 (the preview "
            "grid pulls an extra HOST batch) — set display=0")


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


def data_seed(seed: int, global_step: int) -> int:
    """dataDevice's per-step batch seed: ``step_seed`` moved above 2**31,
    so the batch stream never shares a seed with the preprocess decisions
    (the JAX loop's separate ``kd`` key, loop.py:365-377)."""
    return step_seed(seed, global_step) + 2**31


class _StepProfiler:
    """profileSteps: a ``torch.profiler`` trace over steps [5, 5+N) of the
    run (the JAX loop's window, loop.py:569-577), started and stopped on
    the loop's thread.  CPU activity always, CUDA when the step runs on the
    card; one Chrome trace under ``profileDir``."""

    def __init__(self, opt: Opt, device: torch.device):
        self.opt, self.device = opt, device
        self.prof = None
        self.first = 0          # the global step the trace starts at
        self.done = opt.profileSteps <= 0

    def at_step(self, done: int, global_step: int) -> None:
        """Called at the top of each step with the steps done so far."""
        if self.done:
            return
        if self.prof is None and done == 5:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.first = global_step
            self.prof = profile(activities=acts)
            self.prof.start()
        elif self.prof is not None and done == 5 + self.opt.profileSteps:
            self.stop()

    def stop(self) -> None:
        """Stop a running trace and write it (a no-op otherwise)."""
        if self.prof is None or self.done:
            return
        self.done = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.opt.profileDir, exist_ok=True)
        path = os.path.join(self.opt.profileDir,
                            f"{self.opt.name}_step{self.first}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        print(f"profiler trace: {path}")


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
    if opt.dataDevice:
        check_data_device(opt, regime)
    bad = unsupported_options(opt, regime)
    if bad:
        raise SystemExit("; ".join(bad))
    with_init = bool(opt.withInit and opt.initName)
    if with_init and regime not in ("video", "video3d"):
        raise SystemExit(f"withInit requires regime=video or video3d, not "
                         f"{regime!r}")
    check_eval_options(opt, regime)
    multi = distributed.is_multi()
    world = distributed.process_count()
    rank = distributed.process_index()
    is_main = rank == 0
    # One process without a process group runs the single-device path; a
    # mesh request it cannot meet exits naming the world size.
    axis, n_data, n_shard = mesh_plan(opt, world)
    device = resolve_device(opt)
    seed = opt.manualSeed or int(np.random.randint(1, 10000))
    if multi and not opt.manualSeed:
        # Init and every per-step stream must agree across ranks.
        t = torch.tensor([seed], dtype=torch.int64, device=device)
        seed = int(comm.broadcast_(t, 0).item())
    if is_main:
        print(f"Seed: {seed}")
    mesh = None
    where = None
    if multi:
        from video_filler_tpu_torch.parallel.temporal import make_seq_mesh
        mesh = (make_seq_mesh(n_data, n_shard) if axis == "seq"
                else make_mesh(n_data, n_shard))
        where = coords(mesh)
        if opt.display and is_main:
            print("display grids disabled under multi-process (each rank "
                  "holds a slice of the batch)")
        opt = opt.replace(display=False)
    sampler_opt = opt
    if where is not None:
        _, per_rank = distributed.process_batch_slice(
            opt.batchSize, where.n_data, where.data_rank)
        sampler_opt = opt.replace(batchSize=per_rank)
    sampler, ds_size = make_sampler(sampler_opt, regime)
    state = init_train_state(opt, regime, torch.Generator().manual_seed(seed),
                             mesh)

    start_epoch = 1
    resume_miss = False
    # Checkpoints hold the single-device layout: under a sharded
    # bottleneck the state is gathered to restore into it, then cut again.
    def full():
        return (unsharded(state, mesh) if mesh is not None
                else contextlib.nullcontext(state))

    with full():
        if opt.autoResume:
            # Restart from wherever the last run checkpointed (the
            # reference's only recovery is manual loadName/loadIter,
            # train_vid_weighted.lua:242-257).
            found = restore_latest(opt.checkpointDir, opt.name, state)
            if found is not None:
                start_epoch = found[1] + 1
                if is_main:
                    print(f"auto-resumed {opt.name} at epoch {found[1]}")
        elif opt.loadName and opt.loadIter:
            path = checkpoint_path(opt.checkpointDir, opt.loadName,
                                   opt.loadIter)
            try:
                restore_checkpoint(path, state)
            except FileNotFoundError:
                if not multi:
                    raise
                resume_miss = True  # reported on every rank below
            else:
                start_epoch = opt.loadIter + 1
                if is_main:
                    print(f"Resumed {path} at epoch {opt.loadIter}")
    if multi and (opt.autoResume or (opt.loadName and opt.loadIter)):
        # Rank 0 writes the checkpoints; every rank restores from its own
        # view of checkpointDir.  Unless that is one shared filesystem the
        # ranks resume from different epochs and the step desyncs: every
        # rank exits, with the evidence.
        mine = torch.tensor([-1 if resume_miss else start_epoch],
                            dtype=torch.int64, device=device)
        epochs = [int(e) for e in comm.all_gather(mine)]
        if len(set(epochs)) != 1 or resume_miss:
            raise SystemExit(
                f"multi-process resume desync: per-rank resume epochs "
                f"{epochs} (-1 = checkpoint missing) -- checkpointDir "
                f"{opt.checkpointDir!r} must be a shared filesystem visible "
                "to every process")

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

    if where is not None and where.shard_axis == "seq":
        # each seq rank preprocesses its own frames of the clip
        from video_filler_tpu_torch.parallel.temporal import (
            shard_sp_host_batch,
        )
        preprocess = make_preprocess(
            opt.replace(predLen=opt.predLen // where.n_shard), regime)
    else:
        preprocess = make_preprocess(opt, regime)
    step_fn = make_train_step(opt, regime, with_init=with_init,
                              **({} if mesh is None else {"mesh": mesh}))
    display_gen = torch.Generator().manual_seed(seed + 1)

    # Resume continuity: the restored global step is folded into both
    # random streams.  The step seeds continue the interrupted run's; the
    # loader, whose stream cannot be fast-forwarded, draws a fresh one
    # rather than replaying the run's first batches (JAX loop.py:283-338).
    step0 = state.step
    dev_sampler = None
    if opt.dataDevice:
        # The corpus goes to the device once, as uint8; nothing per step
        # crosses from the host but the generator's seed.
        arrays, dd_meta = device_data.load_corpus(opt, regime)
        if multi:
            # Every rank decodes the (shared) corpus onto its own card.
            # Replicas that differ would train on different data silently:
            # the ranks first agree on a checksum.
            check_corpus(opt, arrays, device)
        corpus = device_data.to_device(arrays, device)
        dev_sampler = device_data.DeviceSampler(opt, regime, dd_meta, device)
        data_gen = torch.Generator(device=device)
        if is_main:
            print(f"dataDevice: {dd_meta['desc']} resident on device "
                  f"({sum(a.nbytes for a in arrays) / 1e6:.0f} MB); "
                  f"per-step host transfer: one seed")
        del arrays
        loader = device_data.NullLoader()
    else:
        # The data rank, not the global rank, seeds the stream: the model
        # or seq ranks of one data group must see the same rows.
        data_rank = where.data_rank if where is not None else 0
        loader = DataLoader(sampler, opt.nThreads,
                            seed=seed + 7919 * data_rank + 104729 * step0,
                            prefetch_depth=opt.prefetchDepth)
    logger = MetricsLogger(opt.name if is_main else f"{opt.name}_p{rank}",
                           quiet=not is_main)
    ntrain = min(ds_size, opt.ntrain)
    steps_per_epoch = max(int(ntrain // opt.batchSize), 1)
    done = 0
    pending_log = None

    def to_device(host_batch):
        return {k: torch.from_numpy(v).to(device)
                for k, v in host_batch.items()}

    rows = None
    if where is not None:
        rows = distributed.data_rows(opt.batchSize, where.n_data,
                                     where.data_rank,
                                     int(opt.gradAccum)).to(device)

    def prepare(batch, gen):
        """A step batch from a loader batch: on a mesh, the preprocess
        decisions drawn for the global batch and this data rank's rows of
        them taken, and on a seq mesh this rank's frames."""
        if where is None:
            return preprocess(batch, gen)
        if where.shard_axis == "seq":
            batch = shard_sp_host_batch(where, batch, nc=opt.nc)
        key = "raw_masked" if regime in ("logo", "wholeim") else "raw"
        return preprocess(batch, draws=global_draws(
            opt, regime, gen, tuple(batch[key].shape), where.n_data,
            where.data_rank))

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

    dashboard = None
    if opt.displayServer and is_main:
        # Live HTTP view over the JSONL and PNG dumps (the reference's
        # `display` server, train.lua:427-445).
        dashboard = Dashboard(opt.name, port=opt.display_port)
        print(f"dashboard: http://localhost:{dashboard.port}/")
    profiler = _StepProfiler(opt if is_main else opt.replace(profileSteps=0),
                             device)

    # SIGTERM (preemption): finish the step in flight, checkpoint, exit
    # cleanly.  The handler only sets a flag; the work happens at the next
    # step boundary on the main thread.
    preempted = threading.Event()
    old_sigterm = None
    # One process only: a signal delivered to one rank would desync the
    # world mid-collective (coordinated preemption is the cluster's job).
    if world == 1 and threading.current_thread() is threading.main_thread():
        old_sigterm = signal.signal(signal.SIGTERM,
                                    lambda signum, frame: preempted.set())

    try:
        for epoch in range(start_epoch, opt.niter + 1):
            t_epoch = time.perf_counter()
            for step in range(steps_per_epoch):
                profiler.at_step(done, step0 + done)
                t0 = time.perf_counter()
                if dev_sampler is None:
                    host_batch = loader.get_batch()
                    t_data = time.perf_counter() - t0
                    batch = to_device(host_batch)
                else:
                    batch = dev_sampler(corpus, data_gen.manual_seed(
                        data_seed(seed, step0 + done)), rows)
                    t_data = time.perf_counter() - t0
                gen = torch.Generator().manual_seed(
                    step_seed(seed, step0 + done))
                batch = prepare(batch, gen)
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
                # Every rank joins the gather of a sharded bottleneck;
                # rank 0 alone writes the full, single-device state.
                with full():
                    if is_main:
                        # Prune BEFORE saving: `keep` finished checkpoints
                        # stay on disk even if the incoming async write
                        # fails.
                        prune_checkpoints(opt.checkpointDir, opt.name,
                                          opt.keepCheckpoints)
                        p = save_checkpoint(
                            opt.checkpointDir, opt.name, epoch, state,
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
        cleanups = [flush_log, profiler.stop, loader.close, logger.close,
                    wait_pending_saves]
        if dashboard is not None:
            cleanups.insert(3, dashboard.close)
        for cleanup in cleanups:
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


def check_corpus(opt: Opt, arrays, device) -> None:
    """dataDevice on several ranks: every rank's decoded corpus has one
    CRC32, or every rank exits naming each rank's value (JAX loop.py
    :299-329)."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    mine = torch.tensor([crc], dtype=torch.int64, device=device)
    crcs = [int(c) for c in comm.all_gather(mine)]
    if len(set(crcs)) != 1:
        raise SystemExit(
            f"dataDevice multi-process: per-rank corpus checksums differ "
            f"({[hex(c) for c in crcs]}) -- DATA_ROOT {opt.DATA_ROOT!r} must "
            "be one shared corpus visible identically to every process")


def main(argv: list[str]):
    regime, rest = split_regime(argv)
    opt = from_args(rest)
    # torchrun's environment: join the world first (NCCL on the card,
    # gloo for device=cpu); a no-op for one process.
    distributed.initialize(device=None if opt.device == "cuda"
                           else opt.device)
    return train(opt, regime)


if __name__ == "__main__":
    main(sys.argv[1:])
