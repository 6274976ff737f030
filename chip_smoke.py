#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is non-zero:
  1. device   -- the card's name and power limit; TF32 set explicitly; no
                 module of jax or of the JAX package (video_filler_tpu)
                 loaded by the port's imports.
  2. build    -- nvcc builds video_filler_tpu_torch/csrc/fused_loss.cu for
                 sm_90a; prints the seconds and ptxas's register report.
                 g++ builds the native decode (csrc/vf_native.cpp, host
                 code); its path, or why it failed, decides and names the
                 host samplers' decode path (native or Python).
  3. kernels  -- the fused weighted-MSE kernels against their plain PyTorch
                 versions on the card, at the operands the main paths give
                 them: the center shape (64,64,64,3) with (1,64,64,1) ring
                 weights in f32 and with bf16 pred, a ragged (3,7,9,5) with
                 strided operands, and the 128x128 regimes -- video
                 (64,128,128,12) bf16 pred with (64,128,128,1) mask weights,
                 one gradAccum 4 microbatch of it, (16,128,128,12) with
                 (16,128,128,1) weights (the center microbatch of batch 512
                 at gradAccum 8 is the center shape itself), the video
                 composite (f32 pred, the same weights), wholeim
                 with full-size weights, logo with a 0-dim weight, and the
                 video3d clips (64,4,128,128,3) bf16 pred with
                 (64,1,128,128,1) mask weights (stride 0 over T) and their
                 f32 composite.
                 Forward rtol 1e-5; backward rtol 1e-6 in f32, one bf16 ulp
                 for bf16 pred; two forwards bitwise equal.  Prints each
                 geometry's plan (row or generic path, index width); times
                 kernel and plain version with a warm L2, and the kernels
                 with the L2 flushed between calls against their bound
                 (the bytes of ``kernel_bytes`` at 3.35 TB/s).  Checks that
                 no single PyTorch call computes the function.
  4. parity   -- one tiny-width f32 train step on the card against the same
                 step on the CPU, for center, video, wholeim and video3d,
                 then for each step option: center conditionAdv, center
                 noiseGen on one fixed z, video gradAccum 2, video remat,
                 center adamMomentsBf16 and center useBias (the CPU port is
                 held against the JAX package by tests/test_torch_*.py);
                 and bf16 at batch 8 on center, card against CPU, with the
                 CPU suite's bf16 parity rules (tests/test_torch_models.py
                 check_bf16_parity).
  5. main     -- ``video_filler_tpu_torch.train.loop.main`` at full width
                 (nef=ngf=ndf=64, nBottleneck=4000, fineSize=128, batch 64,
                 bf16) on synthetic data: center for 5 steps; the canonical
                 video configuration (predLen 4, wtl2 0.999, weight_nomask
                 0.05, maskValue 110/255) for 5 steps with a checkpoint, its
                 autoResume for 5 more, a withInit run from that checkpoint
                 at weight_nomask 0 (composite, f32 pred) for 3; logo and
                 wholeim for 2 each; video3d (the temporal 3-D family,
                 video3dLevels 5, predLen 4, ~279 M G parameters) for 5
                 steps with a checkpoint, its autoResume for 2 more and a
                 withInit run at weight_nomask 0 for 2.  Then the step
                 options, 2 steps each: center conditionAdv; center
                 noiseGen (nz 100, normal), its checkpoint kept for phase
                 7; center gradAccum 8 at batch 512 (microbatches of 64);
                 video adamMomentsBf16 with a checkpoint and 2 more steps on
                 its autoResume (the bf16 moments read back exactly); video
                 remat (its peak memory printed beside the plain video
                 run's); center useBias (G's conv biases trained).  Then
                 ``dataDevice=1`` (the corpus resident on the card, batches
                 synthesised there): center for 10 steps with
                 ``displayServer=1`` (GET /metrics returns the run's steps)
                 and ``profileSteps=3`` (the Chrome trace names both
                 ``wmse_row_*`` kernels, 3 launches each) and a checkpoint
                 for phase 7; video (predLen 4) for 2 steps with a
                 checkpoint and 2 more on its autoResume; video3d and
                 wholeim for 2 each; each run's corpus MB, rejection rounds
                 and host syncs per step; ``load_corpus`` decodes in Python.
                 Every logged metric finite; each loss kernel launched once
                 per microbatch in each direction (steps x gradAccum) on
                 every run, all on the row path (no generic launch).
  6. timing   -- 20 steps on one device-resident batch, center, video,
                 video3d and each step option of phase 5: ms/step,
                 clips/s, peak memory, device idle share.  Then center and
                 video as the loop runs them, batch and all: the host
                 loader's step (decode, copy, preprocess, step) and the
                 ``dataDevice`` step (sampler, preprocess, step) in turns
                 (host, device, device, host): ms/step, idle share, peak
                 memory (the corpus on the card for the device passes
                 only), the sampler's ms alone; the sampler's gathers on
                 the card equal the CPU's on the same decisions (center,
                 video, wholeim; uint8, exactly).
     (--profile adds a torch.profiler table of device time by kernel.)
  7. inference -- in phase 5's directory, on its checkpoints and corpus:
                 tiny f32 inference on the card against the CPU (the
                 loader's forward per regime, rtol 1e-4 / atol 1e-5; the
                 server function of every mode, uint8 within one level);
                 ``load_generator`` of the video checkpoint (conv weights
                 bf16, BN f32, on the card); ``eval.metrics.evaluate`` over
                 2 batches of 64 (every value finite) and
                 ``bench_inference`` at batch 64; ``run_wholeim`` with the
                 initName cascade and ``run_stream`` over 64 frames (their
                 PNGs checked); the video server at batch 64 (64 concurrent
                 single-row requests, each within one level of its solo
                 result; 400, 503 over budget, the drain); the video
                 (withInit cascade) and wholeim full-frame servers at
                 360x480, the input kept outside the mask; the video3d
                 checkpoint: ``load_generator`` (3-D conv weights bf16),
                 ``bench_inference`` at batch 64 and its server under 64
                 concurrent single-row requests; the center noiseGen
                 checkpoint: ``load_generator``, ``evaluate`` and
                 ``bench_inference`` at batch 64, and its server under 16
                 concurrent single-row requests, 8 with their own z (each
                 within one uint8 level of its solo result; a row without
                 noise equal to the zero-noise result).  The Torch7
                 exchange: the port's export CLI writes the dataDevice
                 center checkpoint as a .t7, loaded on the card its G gives
                 the .npz-loaded G's output (rtol 1e-3, atol 1e-3), and a
                 server on the .t7 answers a request within one uint8 level
                 of a server on the .npz.
  8. parallel -- the multi-device paths (parallel/), each world started by
                 ``run_world`` with a time limit.  (a) NCCL, the production
                 backend, at world size 1 with torchrun's environment: a
                 tiny f32 center step through the mesh code equals the
                 plain step on the card (metrics rtol 1e-5); then through
                 ``train.loop.main`` at full width, bf16: center for 3
                 steps with a checkpoint, restored and resumed for 3 more,
                 and video3d for 2.  (b) two ranks sharing the card (gloo,
                 both on cuda:0: NCCL refuses two ranks on one device): at
                 tiny width, f32, DP-2 center, TP-2 center (modelParallel
                 2), TP-2 center noiseGen and SP-2 video3d, each against
                 the one-process step on the card at the CPU suite's
                 tolerances (metrics rtol 1e-4 / atol 1e-5, parameters
                 atol 4.1e-3, BN statistics rtol 1e-4 / atol 1e-5, each
                 net's gradients as Adam's first moments within 0.1 of
                 each leaf's largest value), the replicas bitwise equal;
                 one dataDevice DP-2 center step through the loop against
                 one process (one step: after two, first-step Adam sign
                 flips move the second gradient by more than 0.1 of a
                 leaf); the NCCL world-1 step's moments likewise; then at
                 full
                 width, bf16,
                 2 steps each of DP-2 center, TP-2 center and SP-2 video3d
                 through ``train.loop.main``: metrics finite, loss-kernel
                 launches per rank steps x gradAccum, all on the row path,
                 ms/step (two ranks sharing one card: not a multi-GPU
                 speed), and the count of gloo calls staged through pinned
                 host buffers.  (c) ``dataParallel=2`` serving on one card
                 exits naming the card count; the video, video3d and center
                 noiseGen generators of phase 5 exported with torch.export
                 at batch 64 (eval/export_pt2.py), reloaded, equal to the
                 eager G and within one uint8 level of the server
                 function; exported and eager ms per batch.
Then one JSON line of the kernels' numbers (at the video geometry, and by
geometry under "geometries"; launches per rank of phase 8's runs under
"launches_parallel"), and as the last line
{"ok": true, "device": {...}}.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

WIDTH = ["device=cuda", "batchSize=64", "nef=64", "ngf=64", "ndf=64",
         "nBottleneck=4000", "fineSize=128", "wtl2=0.999",
         "computeDtype=bfloat16", "display=0", "manualSeed=1", "nThreads=4"]
FULL_WIDTH_ARGS = ["regime=center", *WIDTH, "overlapPred=4", "niter=1",
                   "ntrain=320", "checkpointEvery=2", "name=chip_smoke"]
# The reference's canonical video configuration (runtrainvid.sh:31-61).
# maskValue keeps its default, 110/255.
VIDEO_ARGS = ["regime=video", *WIDTH, "predLen=4", "weight_nomask=0.05",
              "loadSize=240"]
# The JAX package's temporal family at its defaults (context_encoder_3d.py):
# five (3,4,4) levels to 4x4, a (T,4,4) valid bottleneck; the video data.
VIDEO3D_ARGS = ["regime=video3d", *WIDTH, "video3dLevels=5", "predLen=4",
                "weight_nomask=0.05", "loadSize=240"]
MAIN_STEPS = 5
OPTION_STEPS = 2              # full-width steps of each step option's run
TIMED_STEPS = 20
FLUSH_BYTES = 256 * 2 ** 20   # written, then read, between cold-L2 calls
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory, NVIDIA's data sheet
INFER_BATCHES = 2
BENCH_ITERS = 20
STREAM_FRAMES = 64
FRAME_H, FRAME_W = 360, 480   # the reference corpus's frame size


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn``: the kernels' own time,
    summed from a torch.profiler trace.  A trace that recorded no device
    activity at all is taken again, up to twice: CUPTI now and then
    delivers an empty one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in device_rows(prof))
        if total_us > 0:
            break
    return total_us / 1e3 / iters


def device_rows(prof):
    """The trace's device activities (kernels, copies, memsets), without
    the annotation ranges that span them."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def cold_device_ms(torch, fn, iters: int, scratch) -> float:
    """Mean device milliseconds per call of ``fn`` with the L2 flushed
    before each call: ``scratch`` (FLUSH_BYTES) is written, then read back,
    so the 50 MB L2 holds other, clean lines.  Only the loss kernels' rows
    of the trace are summed, not the flush.  A trace that missed some of
    the launches is taken again, up to twice: CUPTI now and then drops
    events of the few-microsecond kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                scratch.fill_(1.0)
                scratch.sum()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in device_rows(prof) if "wmse_" in e.key]
        launched = sum(e.count for e in rows)
        if launched == iters:
            break
    if launched != iters:
        fail(f"cold timing: {launched} loss-kernel launches traced for "
             f"{iters} calls")
    return sum(e.self_device_time_total for e in rows) / 1e3 / iters


def check_close(name, got, ref, rtol):
    err = (got.float() - ref.float()).abs()
    bad = err > rtol * ref.float().abs()
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} elements beyond rtol {rtol}, "
             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def check_bf16_ulp(name, got, ref):
    """Each element within one bf16 ulp of ref (8 significant bits)."""
    import torch
    ref32 = ref.float()
    _, exp = torch.frexp(ref32)
    ulp = torch.ldexp(torch.ones_like(ref32), exp - 8)
    err = (got.float() - ref32).abs()
    bad = err > ulp
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} elements beyond one bf16 ulp")
    return float(err.max())


def kernel_operands(torch, losses, masks):
    """(name, pred, target, weights) at the geometries the main paths give
    the loss kernels, on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    real = torch.randn(64, 128, 128, 3, generator=g, device=dev)
    target = masks.extract_center(real)                 # strided view
    ring = losses.overlap_l2_weights((64, 64), 4, 0.999, device=dev)[None]
    pred_c = torch.randn(64, 64, 64, 3, generator=g, device=dev)
    # ragged: pred is a permuted (non-contiguous) view, weights (B,H,W,1)
    pred_r = torch.randn(3, 5, 7, 9, generator=g, device=dev).permute(
        0, 2, 3, 1)
    target_r = torch.randn(3, 7, 9, 5, generator=g, device=dev)
    w_r = torch.rand(3, 7, 9, 1, generator=g, device=dev)
    # video, predLen 4: a contiguous f32 clip, a (B,H,W,1) mask whose
    # weights are wtl2 * (mask*(1-0.05) + 0.05), stride 0 on C
    clip = torch.rand(64, 128, 128, 12, generator=g, device=dev) * 2 - 1
    mask = (torch.rand(64, 128, 128, 1, generator=g, device=dev)
            < 0.3).float()
    w_vid = 0.999 * losses.mask_l2_weights(mask, 0.05)
    fake = (torch.rand(64, 128, 128, 12, generator=g, device=dev) * 2
            - 1).bfloat16()
    composite = masks.fill_in(clip, mask, fake)   # f32, as jnp.where gives
    # wholeim: 2x2 target patches with a full-size mask
    mask_wi = (torch.rand(64, 128, 128, 12, generator=g, device=dev)
               < 0.3).float()
    w_wi = 0.999 * losses.mask_l2_weights(mask_wi, 0.05)
    gt_logo = clip[..., :3].contiguous()
    wtl2 = torch.tensor(0.999, device=dev)
    # video3d, predLen 4: (B,T,H,W,C) clips, a (B,1,H,W,1) mask over T
    clip3 = torch.rand(64, 4, 128, 128, 3, generator=g, device=dev) * 2 - 1
    fake3 = (torch.rand(64, 4, 128, 128, 3, generator=g, device=dev) * 2
             - 1).bfloat16()
    mask3 = (torch.rand(64, 1, 128, 128, 1, generator=g, device=dev)
             < 0.3).float()
    w3 = 0.999 * losses.mask_l2_weights(mask3, 0.05)
    return [
        ("center f32", pred_c, target, ring),
        ("center bf16", pred_c.bfloat16(), target, ring),
        ("ragged f32", pred_r, target_r, w_r),
        ("ragged bf16", pred_r.bfloat16(), target_r, w_r),
        ("video bf16", fake, clip, w_vid),
        # one microbatch of a gradAccum 4 video step at batch 64 (the
        # center microbatch of batch 512 at gradAccum 8 is "center bf16")
        ("video microbatch bf16", fake[:16], clip[:16], w_vid[:16]),
        ("video composite f32", composite, clip, w_vid),
        ("wholeim bf16", fake, clip, w_wi),
        ("logo bf16", fake[..., :3].contiguous(), gt_logo, wtl2),
        ("video3d bf16", fake3, clip3, w3),
        ("video3d composite f32", masks.fill_in(clip3, mask3, fake3), clip3,
         w3),
        # one rank's share under phase 8's two-rank meshes: center and
        # video at DP-2 (half the rows), video3d at SP-2 (half the frames;
        # the mask over T stays whole)
        ("center DP-2 bf16", pred_c[:32].bfloat16(), target[:32], ring),
        ("video DP-2 bf16", fake[:32], clip[:32], w_vid[:32]),
        ("video3d SP-2 bf16", fake3[:, :2].contiguous(),
         clip3[:, :2].contiguous(), w3),
    ]


def kernel_checks(torch, fl, losses, masks, smi):
    """Phase 3: every geometry against the plain version; warm and cold-L2
    device times, bytes, bound and share for all but the ragged ones.
    Returns the numbers by geometry name."""
    gbar = torch.tensor(1.7, device="cuda")
    scratch = torch.empty(FLUSH_BYTES // 4, device="cuda")
    numbers = {}
    for name, p, t, w in kernel_operands(torch, losses, masks):
        pl = fl.plan(p, t, w)
        expect = "generic" if name.startswith("ragged") else "row"
        if pl.variant != expect or not pl.index32:
            fail(f"{name}: planned {pl.variant} (index32 {pl.index32}, "
                 f"{pl.reason or 'no reason'}), expected {expect}, 32-bit")
        if name.endswith("composite f32") and p.dtype != torch.float32:
            fail("the composite of a bf16 fake into the f32 clip is not f32")
        if name.startswith("video3d") and (
                w.expand(p.shape).stride()[1] != 0
                or pl.weight_strides[1] != 0):
            fail(f"{name}: the clip weights are not read by stride 0 over T")
        fwd = fl.launch_forward(p, t, w)
        fwd2 = fl.launch_forward(p, t, w)
        torch.cuda.synchronize()
        if not torch.equal(fwd, fwd2):
            fail(f"{name}: two forward calls differ")
        fwd_err = check_close(f"{name} forward", fwd,
                              fl.weighted_mse_reference(p, t, w), 1e-5)
        grad = fl.launch_backward(p, t, w, gbar)
        ref_grad = fl.weighted_mse_grad_reference(p, t, w, gbar)
        if p.dtype == torch.bfloat16:
            bwd_err = check_bf16_ulp(f"{name} backward", grad, ref_grad)
        else:
            bwd_err = check_close(f"{name} backward", grad, ref_grad, 1e-6)
        # The autograd wrapper on the card: forward + backward kernels.
        leaf = p.detach().clone().requires_grad_(True)
        fl.fused_weighted_mse(leaf, t, w).backward(gbar)
        if not torch.equal(leaf.grad, grad):
            fail(f"{name}: autograd gradient differs from the kernel's")
        print(f"{name:20s} pred {tuple(p.shape)} {str(p.dtype)[6:]} weights "
              f"{tuple(w.shape)} strides {tuple(w.expand(p.shape).stride())}"
              f": fwd max|err| {fwd_err:.3e}  bwd max|err| {bwd_err:.3e}  "
              f"bitwise-repeat ok; plan {pl.variant}, "
              f"{'32' if pl.index32 else '64'}-bit offsets, weights "
              f"{'float4' if pl.weights_vec else 'by stride'}"
              f"{', ' + pl.reason if pl.reason else ''}")
        numbers[name] = dict(fwd_err=fwd_err, bwd_err=bwd_err,
                             variant=pl.variant, index32=pl.index32)
        if name.startswith("ragged"):
            continue
        calls = {
            "fwd": lambda: fl.launch_forward(p, t, w),
            "fwd_plain": lambda: fl.weighted_mse_reference(p, t, w),
            "bwd": lambda: fl.launch_backward(p, t, w, gbar),
            "bwd_plain": lambda: fl.weighted_mse_grad_reference(p, t, w, gbar),
        }
        # Device time from the trace; the event time between 200
        # back-to-back calls is bounded by the host's launch rate.
        dev = {k: device_ms(f, 50) for k, f in calls.items()}
        wall = {k: cuda_ms(f, 200) for k, f in calls.items()}
        for k in calls:
            print(f"{name:20s} {k:9s} device {dev[k] * 1e3:8.2f} us/call"
                  f"  back-to-back {wall[k] * 1e3:8.2f} us/call")
        if min(dev.values()) <= 0:
            fail(f"{name}: the profiler recorded no device time")
        numbers[name].update(dev)
        for k in ("fwd", "bwd"):
            nbytes = fl.kernel_bytes(p, t, w, k)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            cold = cold_device_ms(torch, calls[k], 20, scratch)
            numbers[name].update({f"{k}_bytes": nbytes,
                                  f"{k}_bound": bound, f"{k}_cold": cold})
            print(f"{name:20s} {k:9s} {nbytes} bytes, bound "
                  f"{bound * 1e3:.2f} us; device, L2 flushed "
                  f"{cold * 1e3:.2f} us = {100 * bound / cold:.1f}% of the "
                  f"bound (warm L2 {dev[k] * 1e3:.2f} us); {pl.variant} "
                  f"path, {'32' if pl.index32 else '64'}-bit; on {smi}")
    del scratch
    return numbers


def library_check(torch, fl, losses, masks):
    """The one PyTorch call that might compute the function,
    ``F.mse_loss(weight=)``: show that it is a composite of several kernels
    and that its mean divides by the weights' sum, not N."""
    import inspect

    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    if "weight" not in inspect.signature(F.mse_loss).parameters:
        print(f"library call: none.  F.mse_loss on torch "
              f"{torch.__version__} takes no weights")
        return
    _, p, t, w = kernel_operands(torch, losses, masks)[4]   # video bf16
    wf = w.expand(p.shape).contiguous()   # it takes full-size weights only
    pf = p.float()
    ours = float(fl.weighted_mse_reference(p, t, w))
    lib = float(F.mse_loss(pf, t, weight=wf, reduction="mean"))
    per_sum = float((wf * (pf - t).square()).sum() / wf.sum())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.mse_loss(pf, t, weight=wf, reduction="mean")
        torch.cuda.synchronize()
    kernels = sum(e.count for e in device_rows(prof))
    if kernels < 2 or not math.isclose(lib, per_sum, rel_tol=1e-4) or \
            math.isclose(lib, ours, rel_tol=1e-3):
        fail(f"F.mse_loss(weight=) on torch {torch.__version__}: {kernels} "
             f"kernels, {lib} against sum(w*d^2)/sum(w) {per_sum} and "
             f"sum(w*d^2)/N {ours}: revisit the library column")
    print(f"library call: none.  F.mse_loss(weight=, reduction='mean') on "
          f"torch {torch.__version__} runs {kernels} device kernels per call "
          f"and divides by sum(w) ({lib:.6f}), not by N ({ours:.6f})")


def parity_batches(np):
    """Tiny inputs of each regime the parity phase checks, made with numpy
    from a seed: (regime, extra options, batch)."""
    rs = np.random.RandomState(3)

    def images(c):
        return rs.rand(4, 128, 128, c).astype(np.float32) * 2 - 1

    box = np.zeros((4, 128, 128, 1), np.float32)
    box[:, 40:80, 30:90] = 1.0
    return [
        ("center", dict(overlapPred=4), {"real": images(3)}),
        ("video", dict(predLen=2, weight_nomask=0.05),
         {"real": images(6), "mask": box}),
        ("wholeim", dict(weight_nomask=0.05),
         {"masked": images(27), "real": images(12),
          "mask": np.repeat(box, 12, axis=-1)}),
        ("video3d", dict(predLen=2, weight_nomask=0.05, fineSize=32,
                         video3dLevels=3),
         {"real": rs.rand(4, 2, 32, 32, 3).astype(np.float32) * 2 - 1,
          "mask": box[:, None, 40:72, 40:72]}),
    ]


def parity_check(torch, np, Opt, step_mod):
    """Phase 4: tiny f32 steps, card against CPU, from the same init: each
    regime, then each step option (noiseGen on one fixed z)."""
    base = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=4, wtl2=0.999,
                computeDtype="float32")
    batches = parity_batches(np)
    by_regime = {regime: (extra, batch) for regime, extra, batch in batches}
    z = np.random.RandomState(4).normal(size=(4, 1, 1, 5)).astype(np.float32)
    for regime, kw in (("center", dict(conditionAdv=True)),
                       ("center", dict(noiseGen=True, nz=5)),
                       ("video", dict(gradAccum=2)),
                       ("video", dict(remat=1)),
                       ("center", dict(adamMomentsBf16=True)),
                       ("center", dict(useBias=True))):
        extra, batch = by_regime[regime]
        label = " ".join(f"{k}={v}" for k, v in kw.items())
        batches.append((f"{regime} {label}", {**extra, **kw}, batch))
    for name, extra, batch in batches:
        regime = name.split()[0]
        out = {}
        for device in ("cpu", "cuda"):
            opt = Opt(device=device, **base, **extra)
            state = step_mod.init_train_state(
                opt, regime, torch.Generator().manual_seed(5))
            step = step_mod.make_train_step(opt, regime)
            noise = torch.from_numpy(z).to(device) if opt.noiseGen else None
            metrics = step(state, {k: torch.from_numpy(v).to(device)
                                   for k, v in batch.items()}, noise=noise)
            out[device] = ({k: v.item() for k, v in metrics.items()},
                           [p.detach().cpu() for p in state.gen.parameters()])
        for k, v in out["cpu"][0].items():
            got = out["cuda"][0][k]
            if not math.isclose(got, v, rel_tol=1e-3, abs_tol=1e-6):
                fail(f"parity {name}: {k} on the card {got} vs CPU {v}")
        # First Adam step ~ lr*sign(g): a tiny gradient can flip sign, worth
        # 2*lr_G = 4e-3 (the JAX suite's bound for the same comparison).
        worst = max(float((a - b).abs().max())
                    for a, b in zip(out["cuda"][1], out["cpu"][1]))
        if worst > 4.1e-3:
            fail(f"parity {name}: G params after one step differ by "
                 f"{worst}")
        print(f"card vs CPU, tiny f32 {name} step: metrics within rtol "
              f"1e-3 ({json.dumps(out['cuda'][0])}); G params max|diff| "
              f"{worst:.2e}")
    bf16_parity(torch, np, Opt, step_mod)


BF16_METRICS = ("errD", "errD_real", "errD_fake", "errG", "errG_l2",
                "errG_total")


def bf16_parity(torch, np, Opt, step_mod):
    """Phase 4, bf16 (the default computeDtype): the center case of the CPU
    suite (tests/test_torch_models.py ``check_bf16_parity``) with the card in
    the port's place and the CPU in JAX's.  At nef=ngf=ndf=8, nBottleneck
    16, batch 8 of smooth textures: G's train-mode forward and one step, in
    f32 and bf16 on each device.  The card's bf16-vs-f32 error (mean and
    max abs) at most 1.5x the CPU's; card against CPU in bf16 at most 2x
    the larger max error; each metric within 2x the larger relative
    bf16-vs-f32 change of that metric."""
    from video_filler_tpu_torch.data.synthetic import _texture
    rs = np.random.RandomState(1)
    real = torch.from_numpy(np.stack([_texture(rs, 128, 128)
                                      for _ in range(8)]).astype(np.float32)
                            / 127.5 - 1.0)
    kw = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=8, wtl2=0.999,
              overlapPred=4)
    out = {}
    for device in ("cpu", "cuda"):
        for dt in ("float32", "bfloat16"):
            opt = Opt(device=device, computeDtype=dt, **kw)
            state = step_mod.init_train_state(
                opt, "center", torch.Generator().manual_seed(5))
            x = real.to(device)
            with torch.no_grad():
                g = step_mod.init_train_state(
                    opt, "center", torch.Generator().manual_seed(5)).gen
                y = g.train()(x).float().cpu()
            m = step_mod.make_train_step(opt, "center")(state, {"real": x})
            out[(device, dt)] = (y, {k: m[k].item() for k in BF16_METRICS})
    err = {d: (out[(d, "bfloat16")][0] - out[(d, "float32")][0]).abs()
           for d in ("cpu", "cuda")}
    cross = (out[("cuda", "bfloat16")][0] - out[("cpu", "bfloat16")][0]).abs()
    e = {d: (float(err[d].mean()), float(err[d].max())) for d in err}
    print(f"bf16 vs f32, tiny center G at batch 8: CPU mean {e['cpu'][0]:.3e}"
          f" max {e['cpu'][1]:.3e}; card mean {e['cuda'][0]:.3e} max "
          f"{e['cuda'][1]:.3e}; card vs CPU in bf16 mean "
          f"{float(cross.mean()):.3e} max {float(cross.max()):.3e}")
    if e["cuda"][0] > 1.5 * e["cpu"][0] or e["cuda"][1] > 1.5 * e["cpu"][1]:
        fail("bf16 parity: the card's bf16 error exceeds 1.5x the CPU's")
    if float(cross.max()) > 2 * max(e["cpu"][1], e["cuda"][1]):
        fail("bf16 parity: card and CPU differ in bf16 by more than 2x the "
             "larger bf16-vs-f32 max error")
    for k in BF16_METRICS:
        spread = max(abs(out[(d, "bfloat16")][1][k]
                         / out[(d, "float32")][1][k] - 1)
                     for d in ("cpu", "cuda"))
        got, ref = out[("cuda", "bfloat16")][1][k], out[("cpu", "bfloat16")][1][k]
        print(f"bf16 one-step {k}: card {got:.6f} CPU {ref:.6f}, relative "
              f"{abs(got / ref - 1):.2e} (limit {2 * spread:.2e})")
        if abs(got / ref - 1) > 2 * spread:
            fail(f"bf16 parity: {k} differs by more than 2x its bf16 spread")


def run_main(torch, fl, loop, step_mod, args, name, steps, tmp,
             expect=None, grad_accum=1):
    """Drive ``loop.main`` once from ``tmp`` with the launch counts set to
    0 just before; check the steps it logged (every metric finite) and that
    each loss kernel launched exactly ``grad_accum`` times per step in each
    direction (once per microbatch), all on the row path.  ``expect``: the
    epoch of each of the last ``steps`` logged steps.  Prints the run's
    peak device memory.  Returns (state, launch counts)."""
    for counts in (fl.LAUNCHES, fl.VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0
    cwd = os.getcwd()
    os.chdir(tmp)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        state = loop.main([*args, f"name={name}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {**fl.LAUNCHES, **fl.VARIANT_LAUNCHES}
    with open(os.path.join(tmp, "logs", f"{name}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    logged = [r for r in recs if "step" in r][-steps:]
    if expect is not None and [r["epoch"] for r in logged] != expect:
        fail(f"{name}: logged epochs {[r['epoch'] for r in logged]}, "
             f"expected {expect}")
    if len([r for r in recs if "step" in r]) < steps:
        fail(f"{name}: logged fewer than {steps} steps")
    for r in logged:
        bad = [k for k in step_mod.METRIC_KEYS if not math.isfinite(r[k])]
        if bad:
            fail(f"{name}: non-finite metrics {bad} at step {r['step']}")
    per_dir = steps * grad_accum
    if launches["fwd"] != per_dir or launches["bwd"] != per_dir:
        fail(f"{name}: loss kernels launched {launches} times in {steps} "
             f"steps of {grad_accum} microbatches, not once per microbatch "
             f"in each direction")
    if launches["generic"] or launches["row"] != 2 * per_dir:
        fail(f"{name}: loss kernels launched {launches} times in {steps} "
             f"steps: every launch must take the row path")
    n_params = sum(p.numel() for p in state.gen.parameters())
    print(f"{name}: {steps} full-width steps in {seconds:.1f} s (first-step "
          f"cudnn autotune included); G params {n_params / 1e6:.1f} M; "
          f"peak memory {peak_gb:.2f} GB; kernel launches {launches}; "
          f"errG_l2 by step "
          + " ".join(f"{r['errG_l2']:.4f}" for r in logged))
    return state, launches


def time_step(torch, step_fn, state, batch, label, smi, knum=None):
    """Phase 6 for one configuration: ms/step and clips/s over TIMED_STEPS
    steps on one device-resident batch, peak memory, device idle share."""
    n = batch["real"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step_fn(state, batch), TIMED_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: {step_ms:.2f} ms/step, {n * 1e3 / step_ms:.1f} clips/s, "
          f"peak memory {peak_gb:.2f} GB on {smi}")
    if knum is not None:
        loss_ms = knum["fwd"] + knum["bwd"]
        print(f"{label}: loss kernels (fwd+bwd, device) {loss_ms * 1e3:.1f} "
              f"us = {100 * loss_ms / step_ms:.2f}% of the step")
    step_dev = device_ms(lambda: step_fn(state, batch), 5)
    print(f"{label}: device busy {step_dev:.2f} ms of each {step_ms:.2f} ms "
          f"step: idle share {100 * (1 - step_dev / step_ms):.1f}%")
    return step_ms


def main_path(torch, fl, loop, step_mod, synthetic, make_image_folder, tmp):
    """Phase 5: every regime through ``loop.main`` at full width.  Returns
    the center state and args, the video and video3d args and the launch
    totals, by name."""
    total = {"fwd": 0, "bwd": 0, "row": 0, "generic": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    make_image_folder(j("data"), n=64 * MAIN_STEPS, h=160, w=200)
    # 320 frames: an epoch holds as many batches as the corpus has frames
    # (ntrain is capped by the dataset size, as in the JAX loop).
    synthetic.make_video_corpus(j("corpus"), n_videos=2,
                                frames=32 * MAIN_STEPS, h=240, w=320)
    synthetic.make_mask_png(j("mask.png"), h=240, w=320,
                            box=(100, 130, 170, 220))
    d_masked, d_gt = synthetic.make_paired_folders(j("pairs"), n=128,
                                                   h=160, w=200)
    center_args = [*FULL_WIDTH_ARGS, f"DATA_ROOT={j('data')}"]
    state_c, launches = run_main(torch, fl, loop, step_mod, center_args,
                                 "chip_smoke", MAIN_STEPS, tmp)
    add(launches)
    video = [*VIDEO_ARGS, f"DATA_ROOT={j('corpus')}",
             f"maskName={j('mask.png')}", f"ntrain={64 * MAIN_STEPS}"]
    add(run_main(torch, fl, loop, step_mod,
                 [*video, "niter=1", "checkpointEvery=1"],
                 "video", MAIN_STEPS, tmp, [1] * MAIN_STEPS)[1])
    ckpt = j("checkpoints", "video_1_state.npz")
    if not os.path.exists(ckpt):
        fail(f"the video run wrote no checkpoint {ckpt}")
    state_v, launches = run_main(
        torch, fl, loop, step_mod,
        [*video, "niter=2", "checkpointEvery=2", "autoResume=1"],
        "video", MAIN_STEPS, tmp, [2] * MAIN_STEPS)
    add(launches)
    if state_v.step != 2 * MAIN_STEPS:
        fail(f"the resumed video run ended at step {state_v.step}, "
             f"expected {2 * MAIN_STEPS}")
    del state_v
    add(run_main(
        torch, fl, loop, step_mod,
        [*video[:-1], "ntrain=192", "niter=1", "checkpointEvery=2",
         "withInit=1", f"initName={ckpt}", "weight_nomask=0"],
        "video_withinit", 3, tmp, [1] * 3)[1])
    add(run_main(
        torch, fl, loop, step_mod,
        ["regime=logo", *WIDTH, f"DATA_ROOT={d_masked}",
         f"DATA_ROOT_GT={d_gt}", "loadSize=0", "ntrain=128", "niter=1",
         "checkpointEvery=2"], "logo", 2, tmp, [1] * 2)[1])
    # wholeim keeps its checkpoint for the full-frame server of phase 7
    add(run_main(
        torch, fl, loop, step_mod,
        ["regime=wholeim", *WIDTH, f"DATA_ROOT={j('corpus')}",
         f"maskName={j('mask.png')}", "loadSize=240",
         "weight_nomask=0.05", "ntrain=128", "niter=1",
         "checkpointEvery=1"], "wholeim", 2, tmp, [1] * 2)[1])
    # video3d: 5 steps and a checkpoint, 2 more on its autoResume, and a
    # withInit cascade from the checkpoint at weight_nomask 0 for 2
    video3d = [*VIDEO3D_ARGS, f"DATA_ROOT={j('corpus')}",
               f"maskName={j('mask.png')}"]
    launches3 = {"fwd": 0, "bwd": 0, "row": 0, "generic": 0}
    runs3 = [
        ([f"ntrain={64 * MAIN_STEPS}", "niter=1", "checkpointEvery=1"],
         "video3d", MAIN_STEPS, [1] * MAIN_STEPS),
        (["ntrain=128", "niter=2", "checkpointEvery=5", "autoResume=1"],
         "video3d", 2, [2] * 2),
        (["ntrain=128", "niter=1", "checkpointEvery=5", "withInit=1",
          f"initName={j('checkpoints', 'video3d_1_state.npz')}",
          "weight_nomask=0"], "video3d_withinit", 2, [1] * 2),
    ]
    for extra, name, steps, epochs in runs3:
        state3, launches = run_main(torch, fl, loop, step_mod,
                                    [*video3d, *extra], name, steps, tmp,
                                    epochs)
        if name == "video3d" and state3.step not in (MAIN_STEPS,
                                                      MAIN_STEPS + 2):
            fail(f"the video3d run ended at step {state3.step}")
        del state3
        gc.collect()
        add(launches)
        for k in launches3:
            launches3[k] += launches[k]
    print(f"video3d kernel launches over its 3 runs ({MAIN_STEPS + 4} "
          f"steps): {launches3}")
    options, launches_opt = option_runs(torch, fl, loop, step_mod,
                                        center_args, video, tmp)
    add(launches_opt)
    launches_dd, dd_center = data_device_runs(torch, fl, loop, step_mod,
                                              center_args, video, video3d,
                                              tmp)
    add(launches_dd)
    print(f"kernel launches over every main-path run: {total}")
    return {"center_state": state_c, "center_args": center_args,
            "video": video, "video3d": video3d, "launches": total,
            "launches_video3d": launches3, "options": options,
            "launches_options": launches_opt, "launches_dd": launches_dd,
            "dd_center": dd_center}


def option_runs(torch, fl, loop, step_mod, center_args, video, tmp):
    """Phase 5, the step options: each through ``loop.main`` at full width
    for OPTION_STEPS steps.  center conditionAdv, center noiseGen (nz 100,
    normal; its checkpoint serves phase 7), center gradAccum 8 at batch 512
    (microbatches of 64: one epoch of 320 images is one step), video
    adamMomentsBf16 with a checkpoint and its autoResume (the bf16 moments
    read back exactly), video remat (peak memory beside the plain video
    run's), center useBias.  Returns ({label: (regime, args, gradAccum)},
    the launch totals)."""
    import numpy as np

    from video_filler_tpu_torch.checkpoint import ckpt as ckpt_mod
    from video_filler_tpu_torch.config import from_args, split_regime
    from video_filler_tpu_torch.ops.layers import ConvBase
    from video_filler_tpu_torch.train.optim import AdamBf16Moments
    n = OPTION_STEPS
    center = [*center_args, f"ntrain={64 * n}", "checkpointEvery=5"]
    vid = [*video[:-1], f"ntrain={64 * n}", "niter=1", "checkpointEvery=5"]
    runs = {
        "center_conditionAdv": ("center", [*center, "conditionAdv=1"], 1),
        "center_noiseGen": ("center", [*center, "noiseGen=1", "nz=100",
                                       "noisetype=normal",
                                       "checkpointEvery=1"], 1),
        "center_gradAccum": ("center", [*center_args, "batchSize=512",
                                        "gradAccum=8", f"niter={n}",
                                        "checkpointEvery=5"], 8),
        "video_adamMomentsBf16": ("video", [*vid, "adamMomentsBf16=1",
                                            "checkpointEvery=1"], 1),
        "video_remat": ("video", [*vid, "remat=1"], 1),
        "center_useBias": ("center", [*center, "useBias=1"], 1),
    }
    total = {"fwd": 0, "bwd": 0, "row": 0, "generic": 0}
    for label, (regime, args, accum) in runs.items():
        epochs = list(range(1, n + 1)) if accum > 1 else [1] * n
        state, launches = run_main(torch, fl, loop, step_mod, args, label, n,
                                   tmp, epochs, grad_accum=accum)
        if label == "center_useBias":
            biases = [m.bias for m in state.gen.modules()
                      if isinstance(m, ConvBase)]
            moved = sum(bool(b.abs().max() > 0) for b in biases)
            if len(biases) != 11 or not bool(
                    state.gen.dec.up4.bias.abs().max() > 0):
                fail(f"useBias: G has {len(biases)} conv biases and the "
                     "output conv's did not move from zero")
            print(f"{label}: {moved} of G's {len(biases)} conv biases moved "
                  "from zero (Adam trains them)")
        del state
        gc.collect()
        for k in total:
            total[k] += launches[k]
    # adamMomentsBf16: the autoResume of its checkpoint for n more steps
    label = "video_adamMomentsBf16"
    state, launches = run_main(
        torch, fl, loop, step_mod,
        [*runs[label][1], "niter=2", "checkpointEvery=5", "autoResume=1"],
        label, n, tmp, [2] * n)
    for k in total:
        total[k] += launches[k]
    path = os.path.join(tmp, "checkpoints", f"{label}_1_state.npz")
    back = step_mod.init_train_state(
        from_args(split_regime(runs[label][1])[1]), "video",
        torch.Generator().manual_seed(0))
    ckpt_mod.restore_checkpoint(path, back)
    st = back.opt_g.state[back.gen.enc.conv0.weight]
    flat = ckpt_mod.flatten_state(back)
    with np.load(path) as f:
        stored = {k: f[k] for k in f.files if k.startswith(".opt_")}
    if not (isinstance(state.opt_g, AdamBf16Moments)
            and isinstance(back.opt_g, AdamBf16Moments)
            and st["exp_avg"].dtype == torch.bfloat16
            and int(st["step"]) == n and state.step == 2 * n
            and ".opt_g['mu']['enc']['conv0']['w']" in stored
            and all(np.array_equal(flat[k], v) for k, v in stored.items())):
        fail(f"{label}: the bf16 moments did not come back from {path}")
    print(f"{label}: the autoResume ran on bf16 moments; the checkpoint's "
          f"moments (stored f32) read back into bf16 exactly (count {n})")
    del state, back
    gc.collect()
    print(f"kernel launches over the step-option runs: {total}")
    return runs, total


def data_device_runs(torch, fl, loop, step_mod, center_args, video, video3d,
                     tmp):
    """Phase 5, ``dataDevice=1`` through ``loop.main`` at full width: center
    for 10 steps with the dashboard (read as the loop closes it) and a
    3-step profiler trace (its CUDA kernels read back), checkpointed for
    phase 7; video with a checkpoint and its autoResume; video3d; wholeim.
    Prints each run's rejection rounds and host syncs per step.  Returns
    (the launch totals, the center checkpoint's path)."""
    from video_filler_tpu_torch.data import device_data
    from video_filler_tpu_torch.utils import Dashboard
    n = OPTION_STEPS
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    samplers, seen = [], {}
    make = loop.device_data.DeviceSampler

    def recording(*a, **k):
        samplers.append(make(*a, **k))
        return samplers[-1]

    class Recording(Dashboard):
        def close(self):
            seen["metrics"] = get_status(self.port, "/metrics?n=50")
            super().close()

    vid = [*video[:-1], f"ntrain={64 * n}", "dataDevice=1"]
    runs = [
        ("dd_center", [*center_args, "dataDevice=1", "niter=2",
                       "checkpointEvery=2", "displayServer=1",
                       "display_port=0", "profileSteps=3",
                       f"profileDir={j('profile')}"],
         2 * MAIN_STEPS, [1] * MAIN_STEPS + [2] * MAIN_STEPS),
        ("dd_video", [*vid, "niter=1", "checkpointEvery=1"], n, [1] * n),
        ("dd_video", [*vid, "niter=2", "checkpointEvery=5", "autoResume=1"],
         n, [2] * n),
        ("dd_video3d", [*video3d, f"ntrain={64 * n}", "dataDevice=1",
                        "niter=1", "checkpointEvery=5"], n, [1] * n),
        ("dd_wholeim", ["regime=wholeim", *WIDTH, f"DATA_ROOT={j('corpus')}",
                        f"maskName={j('mask.png')}", "loadSize=240",
                        "weight_nomask=0.05", f"ntrain={64 * n}", "niter=1",
                        "checkpointEvery=5", "dataDevice=1"], n, [1] * n),
    ]
    total = {"fwd": 0, "bwd": 0, "row": 0, "generic": 0}
    loop.device_data.DeviceSampler = recording
    loop.Dashboard = Recording
    try:
        for name, args, steps, epochs in runs:
            state, launches = run_main(torch, fl, loop, step_mod, args, name,
                                       steps, tmp, epochs)
            st = samplers[-1].stats
            if st["batches"] != steps or (
                    st["syncs"] != (0 if name == "dd_center"
                                    else st["rounds"])):
                fail(f"{name}: sampler stats {st} over {steps} steps")
            print(f"{name}: dataDevice sampler {st['batches']} batches, "
                  f"{st['rounds'] / steps:.2f} rounds and "
                  f"{st['syncs'] / steps:.2f} host syncs per step "
                  f"({st['rounds'] - st['batches']} "
                  "extra rejection rounds); load_corpus decoded in Python "
                  "(data/decode.py)")
            if name == "dd_video" and "autoResume=1" in args \
                    and state.step != 2 * n:
                fail(f"the resumed dataDevice video run ended at step "
                     f"{state.step}")
            del state
            gc.collect()
            for k in total:
                total[k] += launches[k]
    finally:
        loop.device_data.DeviceSampler = make
        loop.Dashboard = Dashboard
    code, body = seen.get("metrics", (None, b""))
    steps = [r["step"] for r in json.loads(body) if "step" in r] \
        if code == 200 else []
    if steps != list(range(MAIN_STEPS)) * 2:
        fail(f"dashboard: GET /metrics gave {code}, steps {steps}")
    print(f"dashboard: GET /metrics during dd_center returned its "
          f"{len(steps)} logged steps; closed with the run")
    traces = [f for f in os.listdir(j("profile")) if f.endswith(".json")]
    if len(traces) != 1:
        fail(f"profileSteps=3 wrote {traces} under {j('profile')}")
    with open(j("profile", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(k in name for name in kernels)
              for k in ("wmse_row_fwd_kernel", "wmse_row_bwd_kernel")}
    if counts != {k: 3 for k in counts}:
        fail(f"profiler trace {traces[0]}: loss-kernel launches {counts} "
             "over its 3 steps")
    print(f"profiler trace {traces[0]}: {len(kernels)} CUDA kernels over 3 "
          f"steps, among them {counts}")
    print(f"kernel launches over the dataDevice runs: {total}")
    return total, j("checkpoints", "dd_center_2_state.npz")


def sampler_parity(torch, device_data, opt, regime, arrays, meta):
    """The dataDevice gathers on the card against the same gathers on the
    CPU, one batch of decisions drawn on the card: uint8, exactly equal."""
    dev = device_data.DeviceSampler(opt, regime, meta, opt.device)
    cpu = device_data.DeviceSampler(opt.replace(device="cpu"), regime, meta,
                                    "cpu")
    d = dev.draws(torch.Generator(device=opt.device).manual_seed(5),
                  opt.batchSize)
    got = dev.gather(device_data.to_device(arrays, opt.device), d)
    ref = cpu.gather(device_data.to_device(arrays, "cpu"),
                     {k: v.cpu() for k, v in d.items()})
    for k in ref:
        if got[k].device.type != "cuda" or \
                not torch.equal(got[k].cpu(), ref[k]):
            fail(f"dataDevice {regime}: the card's {k} gather differs from "
                 "the CPU's on the same decisions")
    print(f"dataDevice {regime}: the card's gathers equal the CPU's on one "
          f"batch of the card's decisions ({', '.join(f'{k} {tuple(v.shape)}' for k, v in got.items())})")


def data_device_timing(torch, np, step_mod, loop, from_args, split_regime,
                       run, smi):
    """Phase 6, center and video as the loop runs them: the host loader's
    step (a batch from the threaded samplers, copied, preprocessed, the
    step; the previous step's metrics read, as the loop logs them) and the
    dataDevice step (the sampler on the resident corpus, preprocess, the
    step), in turns host, device, device, host on one state, each over
    TIMED_STEPS after its warm-up.  The corpus is on the card for the
    device passes only, so their peak memory counts it and the host
    passes' does not.  No claim is made."""
    from video_filler_tpu_torch.data import device_data
    from video_filler_tpu_torch.data.pipeline import DataLoader, make_sampler
    for regime, args in (("center", run["center_args"]),
                         ("video", run["video"])):
        opt = from_args(split_regime(args)[1])
        state = step_mod.init_train_state(opt, regime,
                                          torch.Generator().manual_seed(0))
        preprocess = step_mod.make_preprocess(opt, regime)
        step_fn = step_mod.make_train_step(opt, regime)
        loader = DataLoader(make_sampler(opt, regime)[0], opt.nThreads,
                            seed=1, prefetch_depth=opt.prefetchDepth)
        t0 = time.perf_counter()
        arrays, meta = device_data.load_corpus(opt, regime)
        load_s = time.perf_counter() - t0
        mb = sum(a.nbytes for a in arrays) / 1e6
        sampler_parity(torch, device_data, opt, regime, arrays, meta)
        sampler = device_data.DeviceSampler(opt, regime, meta, opt.device)
        dgen = torch.Generator(device=opt.device)
        prev, corpus = {}, None

        def host_batch(i):
            return {k: torch.from_numpy(v).to(opt.device)
                    for k, v in loader.get_batch().items()}

        def dev_batch(i):
            return sampler(corpus, dgen.manual_seed(loop.data_seed(1, i)))

        def one(get, i):
            batch = preprocess(get(i), torch.Generator().manual_seed(i))
            if prev:
                float(prev["m"]["errG_l2"])   # the loop's one-late read
            prev["m"] = step_fn(state, batch)

        def timed(get, warm, steps=TIMED_STEPS):
            for i in range(warm):
                one(get, i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(steps):
                one(get, i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
            busy = device_ms(lambda: one(get, 0), 5)
            return ms, busy, torch.cuda.max_memory_allocated() / 1e9

        try:
            out = {"host": [], "device": []}
            # the host loader's warm-up drains its prefetched backlog, so
            # the timed steps wait on what the threads decode meanwhile;
            # the corpus is resident for the device passes only
            backlog = opt.nThreads * opt.prefetchDepth
            for kind in ("host", "device", "device", "host"):
                if kind == "device" and corpus is None:
                    corpus = device_data.to_device(arrays, opt.device)
                if kind == "host" and corpus is not None:
                    sample_ms = cuda_ms(lambda: dev_batch(0), 20)
                    corpus = None
                out[kind].append(
                    timed(host_batch, 3 + backlog) if kind == "host"
                    else timed(dev_batch, 3))
        finally:
            loader.close()
        st = sampler.stats
        rounds, syncs = (st[k] / st["batches"] for k in ("rounds", "syncs"))
        for kind, rows in out.items():
            for i, (ms, busy, peak) in enumerate(rows):
                print(f"{regime} loop step, {kind} batches ({i + 1} of 2): "
                      f"{ms:.2f} ms/step, {opt.batchSize * 1e3 / ms:.1f} "
                      f"clips/s, device busy {busy:.2f} ms, idle share "
                      f"{100 * (1 - busy / ms):.1f}%, peak memory "
                      f"{peak:.2f} GB on {smi}")
        print(f"{regime} dataDevice: corpus {mb:.1f} MB resident "
              f"({meta['desc']}; load_corpus {load_s:.1f} s in Python), "
              f"sampler {sample_ms:.3f} ms per batch alone, {rounds:.2f} "
              f"rounds and {syncs:.2f} host syncs per batch")
        del state, arrays, sampler, prev
        gc.collect()
    data = [a for a in run["video"] if a.startswith(("DATA_ROOT=",
                                                      "maskName="))]
    opt = from_args([*WIDTH, "loadSize=240", *data])
    sampler_parity(torch, device_data, opt, "wholeim",
                   *device_data.load_corpus(opt, "wholeim"))


def t7_exchange(torch, np, from_args, split_regime, center_args, net, tmp,
                smi):
    """Phase 7, the Torch7 exchange on the card: the port's export CLI
    writes the dataDevice center checkpoint as a .t7; its G on the card
    against the .npz's (rtol 1e-3, atol 1e-3); one request to a server on
    each, within one uint8 level."""
    from video_filler_tpu_torch.eval import export
    from video_filler_tpu_torch.eval.common import load_generator
    from video_filler_tpu_torch.serve import InpaintServer
    out = os.path.join(tmp, "dd_center_netG.t7")
    export.main(["regime=center", f"net={net}", f"out={out}",
                 *split_regime(center_args)[1]])
    opt = from_args(split_regime(center_args)[1])
    x = torch.from_numpy(np.random.RandomState(11).uniform(
        -1, 1, (64, 128, 128, 3)).astype(np.float32)).to(opt.device)
    with torch.inference_mode():
        ref = load_generator(opt, "center", net)(x).float()
        g7 = load_generator(opt, "center", out)
        got = g7(x).float()
    if next(g7.parameters()).device.type != "cuda":
        fail("the .t7 generator is not on the card")
    err = (got - ref).abs()
    if bool((err > 1e-3 + 1e-3 * ref.abs()).any()):
        fail(f".t7 G against the .npz G: max|diff| {float(err.max()):.3e}")
    print(f"Torch7: exported {os.path.basename(net)} to "
          f"{os.path.basename(out)} ({os.path.getsize(out)} bytes); its G on "
          f"the card at batch 64 within {float(err.max()):.2e} of the .npz "
          "G's (rtol 1e-3, atol 1e-3)")
    rs = np.random.RandomState(12)
    ctx = rs.randint(0, 256, (128, 128, 3), np.uint8)
    answers = []
    for path in (out, net):
        srv = InpaintServer(opt, "center", path, max_delay_ms=1.0)
        try:
            t0 = time.perf_counter()
            code, got_u8 = post(srv.port, ctx=ctx)
            ms = (time.perf_counter() - t0) * 1e3
            if code != 200:
                fail(f"server on {os.path.basename(path)}: HTTP {code}")
            answers.append(got_u8)
        finally:
            srv.close()
    n = u8_levels("server on the .t7 against the .npz", *answers)
    print(f"Torch7: a server on the .t7 answered one request in {ms:.1f} ms "
          f"on {smi}, within one uint8 level of the .npz server ({n} values "
          "differ)")


def timing(torch, step_mod, from_args, split_regime, run, knum, smi_line,
           profile):
    """Phase 6: center, video and video3d steps, each on one
    device-resident batch with only its own state alive.  The center state
    is dropped from ``run`` once timed."""
    state_c = run.pop("center_state")
    g = torch.Generator(device="cuda").manual_seed(0)
    opt = from_args(split_regime(run["center_args"])[1])
    raw = torch.randint(0, 256, (64, 128, 128, 3), generator=g,
                        dtype=torch.uint8, device="cuda")
    batch = step_mod.make_preprocess(opt, "center")(
        {"raw": raw}, torch.Generator().manual_seed(0))
    time_step(torch, step_mod.make_train_step(opt, "center"), state_c, batch,
              "center step, batch 64, full width, bf16", smi_line,
              knum["center bf16"])
    # Each configuration's peak memory holds its own state only.
    del state_c, batch
    gc.collect()
    opt = from_args(split_regime(run["video"])[1])
    state = step_mod.init_train_state(opt, "video",
                                      torch.Generator().manual_seed(0))
    raw = torch.randint(0, 256, (64, 128, 128, 12), generator=g,
                        dtype=torch.uint8, device="cuda")
    mask = torch.zeros(64, 128, 128, 1, dtype=torch.uint8, device="cuda")
    mask[:, 40:80, 30:90] = 1
    batch = step_mod.make_preprocess(opt, "video")(
        {"raw": raw, "mask": mask}, torch.Generator().manual_seed(0))
    step_fn = step_mod.make_train_step(opt, "video")
    time_step(torch, step_fn, state, batch,
              "video step, batch 64, predLen 4, full width, bf16", smi_line,
              knum["video bf16"])
    if profile:
        profile_table(torch, step_fn, state, batch)
    del state, batch, step_fn
    gc.collect()
    opt = from_args(split_regime(run["video3d"])[1])
    state = step_mod.init_train_state(opt, "video3d",
                                      torch.Generator().manual_seed(0))
    batch = step_mod.make_preprocess(opt, "video3d")(
        {"raw": raw, "mask": mask}, torch.Generator().manual_seed(0))
    step_fn = step_mod.make_train_step(opt, "video3d")
    time_step(torch, step_fn, state, batch,
              "video3d step, batch 64, predLen 4, video3dLevels 5, full "
              "width, bf16", smi_line, knum["video3d bf16"])
    if profile:
        profile_table(torch, step_fn, state, batch)
    del state, batch, step_fn
    gc.collect()
    # the step options of phase 5, each on its own state (noiseGen on one
    # fixed z), the batch made as above
    for label, (regime, args, _) in run["options"].items():
        opt = from_args(split_regime(args)[1])
        state = step_mod.init_train_state(opt, regime,
                                          torch.Generator().manual_seed(0))
        n = opt.batchSize
        if regime == "center":
            raw = torch.randint(0, 256, (n, 128, 128, 3), generator=g,
                                dtype=torch.uint8, device="cuda")
            host = {"raw": raw}
        else:
            host = {"raw": torch.randint(0, 256, (n, 128, 128, 12),
                                         generator=g, dtype=torch.uint8,
                                         device="cuda"), "mask": mask}
        batch = step_mod.make_preprocess(opt, regime)(
            host, torch.Generator().manual_seed(0))
        step = step_mod.make_train_step(opt, regime)
        z = step_mod.draw_noise(opt, torch.Generator().manual_seed(0), n,
                                "cuda") if opt.noiseGen else None
        time_step(torch, lambda s_, b_: step(s_, b_, noise=z), state, batch,
                  f"{label} step, batch {n}"
                  f"{f', gradAccum {opt.gradAccum}' if opt.gradAccum > 1 else ''}"
                  ", full width, bf16", smi_line)
        del state, batch, step, host
        gc.collect()


def profile_table(torch, step_fn, state, batch):
    """--profile: device time by kernel over 5 steps."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step_fn(state, batch)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=40, max_name_column_width=90))
    rows = sorted(device_rows(prof),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows)
    print(f"device activities over 5 steps: {busy / 1e3:.2f} ms")
    for e in rows[:40]:
        print(f"{100 * e.self_device_time_total / busy:6.2f}% "
              f"{e.self_device_time_total / 5e3:8.3f} ms/step "
              f"x{e.count // 5:<4d} {e.key[:110]}")


def tiny_checkpoint(torch, Opt, step_mod, ckpt_mod, tmp, regime, **kw):
    """(Opt on the CPU, path): a tiny f32 port checkpoint of ``regime``, G's
    weights scaled by 2 and its BN running statistics drawn away from their
    init values, so that eval mode and the statistics it reads matter.  (By
    4, tanh saturates and the net amplifies f32 rounding past 1e-3.)"""
    opt = Opt(device="cpu", nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=2,
              computeDtype="float32", **kw)
    state = step_mod.init_train_state(opt, regime,
                                      torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in state.gen.parameters():
            p.mul_(2.0)
        for name, b in state.gen.named_buffers():
            b.copy_(torch.rand(b.shape, generator=g) * 1.5 + 0.5
                    if name.endswith("running_var")
                    else torch.randn(b.shape, generator=g) * 0.3)
    return opt, ckpt_mod.save_checkpoint(tmp, f"tiny_{regime}", 1, state)


def post(port, **arrays):
    """POST an npz to /inpaint; (HTTP status, the "out" array or None)."""
    import io
    import urllib.error
    import urllib.request

    import numpy as np
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://localhost:{port}/inpaint",
                                 data=buf.getvalue(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            with np.load(io.BytesIO(r.read()), allow_pickle=False) as d:
                return r.status, d["out"]
    except urllib.error.HTTPError as e:
        return e.code, None


def get_status(port, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def u8_levels(name, got, ref):
    """Fail unless uint8 ``got`` is within one level of ``ref``; the count
    of pixels that differ at all."""
    import numpy as np
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    if got.shape != ref.shape or int(diff.max()) > 1:
        fail(f"{name}: uint8 outputs differ by more than one level "
             f"({int((diff > 1).sum())} pixels)")
    return int((diff > 0).sum())


def inference_parity(torch, np, Opt, step_mod, tmp):
    """Phase 7, first part: tiny f32 inference on the card against the CPU,
    the loader's forward per regime and the server function per mode."""
    from video_filler_tpu_torch.checkpoint import ckpt as ckpt_mod
    from video_filler_tpu_torch.eval.common import load_generator
    from video_filler_tpu_torch.serve import InpaintServer

    v3d = dict(predLen=2, fineSize=32, video3dLevels=3)
    nets = {r: tiny_checkpoint(torch, Opt, step_mod, ckpt_mod, tmp, r, **kw)
            for r, kw in (("center", dict(overlapPred=4)),
                          ("video", dict(predLen=2)), ("wholeim", {}),
                          ("video3d", v3d))}
    rs = np.random.RandomState(4)
    for regime, (opt, path) in nets.items():
        shape = {"center": (128, 128, 3), "video": (128, 128, 6),
                 "wholeim": (128, 128, 27), "video3d": (2, 32, 32, 3)}[regime]
        x = torch.from_numpy(rs.uniform(-1, 1, (2,) + shape)
                             .astype(np.float32))
        with torch.inference_mode():
            ref = load_generator(opt, regime, path, "cpu")(x)
            got = load_generator(opt.replace(device="cuda"), regime, path,
                                 "cuda")(x.cuda()).cpu()
        err = (got - ref).abs()
        if bool((err > 1e-5 + 1e-4 * ref.abs()).any()):
            fail(f"load_generator {regime}: card and CPU differ by "
                 f"{float(err.max()):.3e}")
        print(f"card vs CPU, tiny f32 {regime} generator forward: max|diff| "
              f"{float(err.max()):.2e} (rtol 1e-4, atol 1e-5)")

    def box(h, w, *boxes):
        m = np.zeros((2, h, w, 1), np.uint8)
        for y0, y1, x0, x1 in boxes:
            m[:, y0:y1, x0:x1] = 1
        return m

    video_net = nets["video"][1]
    modes = [
        ("video composite", "video", {}, (2, 128, 128, 6),
         box(128, 128, (40, 80, 30, 90))),
        ("center paste", "center", {}, (2, 128, 128, 3),
         box(128, 128, (0, 128, 0, 128))),
        ("wholeim patch", "wholeim", {}, (2, 128, 128, 27),
         box(128, 128, (0, 128, 0, 128))),
        ("wholeim frame", "wholeim", dict(frameH=180, frameW=240),
         (2, 180, 240, 3), box(180, 240, (30, 60, 40, 80))),
        ("video frame + initName", "video",
         dict(frameH=180, frameW=240, withInit=True, initName=video_net),
         (2, 180, 240, 6), box(180, 240, (20, 70, 30, 90))),
        ("video3d composite", "video3d", {}, (2, 32, 32, 6),
         box(32, 32, (8, 20, 6, 26))),
    ]
    for name, regime, kw, shape, mask in modes:
        opt, path = nets[regime]
        ctx = rs.randint(0, 256, shape, np.uint8)
        out = {}
        for device in ("cpu", "cuda"):
            srv = InpaintServer(opt.replace(device=device, **kw), regime,
                                path, device_thread=False)
            try:
                out[device] = srv._serve_fn(ctx, mask)
            finally:
                srv.close()
        n = u8_levels(f"server {name}", out["cuda"], out["cpu"])
        print(f"card vs CPU, tiny f32 server function, {name}: {n} of "
              f"{out['cpu'].size} uint8 values differ, none by more than 1")


def inference(torch, np, fl, Opt, from_args, split_regime, step_mod, video,
              video3d, noise_args, center_args, dd_net, tmp, smi):
    """Phase 7: the loader, eval.metrics, the tiled and streaming evals and
    the server, at full width on the phase 5 checkpoints and corpus; then
    the Torch7 exchange on the dataDevice center checkpoint."""
    from video_filler_tpu_torch.eval import metrics
    from video_filler_tpu_torch.eval.common import load_generator
    from video_filler_tpu_torch.eval.stream import run_stream
    from video_filler_tpu_torch.eval.wholeim import run_wholeim
    from video_filler_tpu_torch.serve import InpaintServer

    for k in fl.LAUNCHES:
        fl.LAUNCHES[k] = 0
    inference_parity(torch, np, Opt, step_mod, tmp)

    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    net = j("checkpoints", "video_2_state.npz")
    vopt = from_args(split_regime(video)[1]).replace(net=net)
    gen = loaded_generator(torch, load_generator, vopt, "video", net)

    t0 = time.perf_counter()
    q = metrics.evaluate(vopt, "video", n_batches=INFER_BATCHES, loaded=gen)
    bad = [k for k, v in q.items() if not math.isfinite(v)]
    if bad:
        fail(f"evaluate: non-finite {bad}")
    print(f"evaluate, video predLen 4, {INFER_BATCHES} batches of 64 in "
          f"{time.perf_counter() - t0:.1f} s: psnr {q['psnr_db']:.3f} dB, "
          f"ssim {q['ssim']:.4f}, l2 {q['l2']:.5f}, hole_l2 "
          f"{q['hole_l2']:.5f}")
    s = metrics.bench_inference(vopt, "video", iters=BENCH_ITERS, loaded=gen)
    print(f"bench_inference, video G, batch 64, bf16, {BENCH_ITERS} "
          f"iterations: {s['clips_per_sec']:.1f} clips/s, "
          f"{s['frames_per_sec']:.1f} frames/s, batch latency "
          f"{s['batch_latency_ms']:.2f} ms on {smi}")
    del gen

    t0 = time.perf_counter()
    w = run_wholeim(vopt.replace(initName=net), out_dir=j("wholeim_eval"))
    pm = w["padmask"][None] > 0
    if not (np.isfinite(w["pred"]).all() and pm.any()
            and np.array_equal(np.where(pm, 0, w["inpaint"]),
                               np.where(pm, 0, w["input"]))):
        fail("run_wholeim: non-finite output or a change outside the mask")
    pngs = [f"{k}_{t}.png" for k in ("pred", "inpaint", "inpaint_crop",
                                     "orig") for t in range(1, 5)]
    missing = [p for p in pngs if not os.path.exists(j("wholeim_eval", p))]
    if missing:
        fail(f"run_wholeim wrote no {missing}")
    print(f"run_wholeim with the initName cascade: {w['pred'].shape} "
          f"predicted frames, {len(pngs)} PNGs and 3 GIFs in "
          f"{time.perf_counter() - t0:.1f} s")
    st = run_stream(vopt, num_frames=STREAM_FRAMES, out_dir=j("stream"))
    last = j("stream", f"inpaint_{STREAM_FRAMES:05d}.png")
    if st["n_frames"] != STREAM_FRAMES or not os.path.exists(last):
        fail(f"run_stream: {st['n_frames']} frames, {last} missing")
    print(f"run_stream, {STREAM_FRAMES} frames at 240x320 (6 tiles per "
          f"4-frame window): {st['fps']:.1f} frames/s on {smi}")

    srv = InpaintServer(vopt, "video", net, max_delay_ms=5.0)
    try:
        rs = np.random.RandomState(7)
        ctxs = [rs.randint(0, 256, (128, 128, 12), np.uint8)
                for _ in range(64)]
        mask = np.zeros((128, 128, 1), np.uint8)
        mask[40:80, 30:90] = 1
        burst(np, srv, ctxs, mask, "video batch 64", smi)
        if post(srv.port, ctx=ctxs[0][:64])[0] != 400:
            fail("server: a wrongly shaped request was not refused with 400")
        with srv._stats_lock:          # the backlog full, as infer() fills it
            srv._pending_rows += srv._max_pending_rows
        over = post(srv.port, ctx=ctxs[0])[0]
        with srv._stats_lock:
            srv._pending_rows -= srv._max_pending_rows
        srv.initiate_drain()
        health = get_status(srv.port, "/healthz")[0]
        drained = post(srv.port, ctx=ctxs[0])[0]
        srv._worker.join(timeout=30)
        if (over, health, drained) != (503, 503, 503) or \
                srv._worker.is_alive():
            fail(f"server: over budget {over}, healthz while draining "
                 f"{health}, request while draining {drained}, worker alive "
                 f"{srv._worker.is_alive()}")
        print("server: 400 on a wrong shape, 503 over budget, 503 and "
              "/healthz 503 while draining, then the worker returned")
    finally:
        srv.close()

    wi_net = j("checkpoints", "wholeim_1_state.npz")
    full = [("video", net, vopt.replace(
                batchSize=8, frameH=FRAME_H, frameW=FRAME_W, withInit=True,
                initName=net), 12),
            ("wholeim", wi_net, from_args(
                [*WIDTH, "batchSize=8", f"frameH={FRAME_H}",
                 f"frameW={FRAME_W}", "predLen=1"]), 3)]
    rs = np.random.RandomState(8)
    for regime, path, opt, c in full:
        srv = InpaintServer(opt, regime, path, max_delay_ms=1.0)
        try:
            frame = rs.randint(0, 256, (FRAME_H, FRAME_W, c), np.uint8)
            fmask = np.zeros((FRAME_H, FRAME_W, 1), np.uint8)
            fmask[20:90, 30:170] = 1
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                code, out = post(srv.port, ctx=frame, mask=fmask)
                ms.append((time.perf_counter() - t0) * 1e3)
                if code != 200:
                    fail(f"{regime} full-frame server: HTTP {code}")
            if ms[0] > 250 + 3 * max(ms[1:]):
                fail(f"{regime} full-frame server: the first request took "
                     f"{ms[0]:.1f} ms: the constructor's warm-up missed it")
            outside = np.broadcast_to(fmask == 0, frame.shape)
            if not np.array_equal(out[outside], frame[outside]) or \
                    np.array_equal(out[~outside], frame[~outside]):
                fail(f"{regime} full-frame server: the composite is not the "
                     "input outside the mask and G inside it")
            print(f"{regime} full-frame server, {FRAME_H}x{FRAME_W}, batch "
                  f"8{' with the initName cascade' if regime == 'video' else ''}"
                  f": one request {' / '.join(f'{m:.1f}' for m in ms)} ms "
                  f"on {smi}; the input kept outside the mask")
        finally:
            srv.close()
    video3d_inference(torch, np, metrics, load_generator, InpaintServer,
                      from_args(split_regime(video3d)[1]),
                      j("checkpoints", "video3d_1_state.npz"), smi)
    noise_inference(torch, np, metrics, load_generator, InpaintServer,
                    from_args(split_regime(noise_args)[1]),
                    j("checkpoints", "center_noiseGen_1_state.npz"), smi)
    t7_exchange(torch, np, from_args, split_regime, center_args, dd_net, tmp,
                smi)
    print(f"loss-kernel launches during inference: {dict(fl.LAUNCHES)} "
          f"(inference runs no hand-written kernel)")


def loaded_generator(torch, load_generator, opt, regime, net):
    """``load_generator`` on the card, checked: every conv weight (2-D or
    3-D) bf16, every BatchNorm leaf f32, eval mode."""
    from video_filler_tpu_torch.ops.layers import ConvBase
    gen = load_generator(opt, regime, net)
    convs = [m.weight for m in gen.modules() if isinstance(m, ConvBase)]
    bns = [t for n, t in gen.state_dict().items() if "bn" in n]
    if not all(w.dtype == torch.bfloat16 and w.is_cuda for w in convs):
        fail("load_generator left a conv weight off the card or not bf16")
    if not all(t.dtype == torch.float32 and t.is_cuda for t in bns):
        fail("load_generator left a BatchNorm leaf off the card or not f32")
    if gen.training:
        fail("load_generator left G in train mode")
    print(f"load_generator {os.path.basename(net)}: {len(convs)} conv "
          f"weights ({convs[0].dim()}-D) bf16 and {len(bns)} BatchNorm "
          f"leaves f32 on {convs[0].device}; eval mode")
    return gen


def burst(np, srv, ctxs, mask, label, smi):
    """64 concurrent single-row requests: items/s and /stats; each row
    within one uint8 level of its solo result, the input kept outside the
    mask."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ctxs)) as pool:
        outs = list(pool.map(lambda c: post(srv.port, ctx=c, mask=mask),
                             ctxs))
    dt = time.perf_counter() - t0
    st = srv.stats()
    print(f"server, {label}, {len(ctxs)} concurrent single-row requests: "
          f"{len(ctxs) / dt:.1f} items/s, p50 {st['p50_ms']:.1f} ms, p95 "
          f"{st['p95_ms']:.1f} ms, avg_fill {st['avg_fill']:.3f} over "
          f"{st['batches']} batches on {smi}")
    n_diff = 0
    for (code, out), c in zip(outs, ctxs):
        code_solo, solo = post(srv.port, ctx=c, mask=mask)
        if code != 200 or code_solo != 200:
            fail(f"server {label}: HTTP {code} / {code_solo}")
        n_diff += u8_levels(f"server {label} row against its solo result",
                            out, solo)
        if not np.array_equal(out[mask[..., 0] == 0], c[mask[..., 0] == 0]):
            fail(f"server {label}: the composite changed a pixel outside "
                 "the mask")
    print(f"server, {label}: each row within one uint8 level of its solo "
          f"result ({n_diff} values differ); the input kept outside the "
          f"mask")


def video3d_inference(torch, np, metrics, load_generator, InpaintServer,
                      opt, net, smi):
    """Phase 7 for the video3d checkpoint of phase 5: the loader,
    ``bench_inference`` at batch 64 and the server under a burst."""
    opt = opt.replace(net=net)
    gen = loaded_generator(torch, load_generator, opt, "video3d", net)
    s = metrics.bench_inference(opt, "video3d", iters=BENCH_ITERS,
                                loaded=gen)
    side = 4 * 2 ** opt.video3dLevels
    print(f"bench_inference, video3d G, batch {opt.batchSize}, "
          f"({opt.batchSize},{opt.predLen},{side},{side},{opt.nc}) clips, "
          f"bf16, {BENCH_ITERS} iterations: {s['clips_per_sec']:.1f} "
          f"clips/s, {s['frames_per_sec']:.1f} frames/s, batch latency "
          f"{s['batch_latency_ms']:.2f} ms on {smi}")
    del gen
    srv = InpaintServer(opt, "video3d", net, max_delay_ms=5.0)
    try:
        rs = np.random.RandomState(9)
        shape = (srv.in_h, srv.in_w, srv.in_c)     # folded clips
        ctxs = [rs.randint(0, 256, shape, np.uint8) for _ in range(64)]
        mask = np.zeros(shape[:2] + (1,), np.uint8)
        mask[side // 4:side // 2, side // 8:side * 3 // 4] = 1
        burst(np, srv, ctxs, mask, f"video3d batch {opt.batchSize}", smi)
    finally:
        srv.close()


def noise_inference(torch, np, metrics, load_generator, InpaintServer, opt,
                    net, smi):
    """Phase 7 for the center noiseGen checkpoint of phase 5: the loader
    (the noise projection's weights bf16 too), ``evaluate`` (one z per
    batch) and ``bench_inference`` (one fixed z) at batch 64, and a
    noiseGen server: 16 concurrent single-row requests, half of them with
    their own z, each within one uint8 level of its solo result; a row
    posted without noise equals the same row posted with zeros."""
    opt = opt.replace(net=net)
    gen = loaded_generator(torch, load_generator, opt, "center", net)
    q = metrics.evaluate(opt, "center", n_batches=INFER_BATCHES, loaded=gen)
    bad = [k for k, v in q.items() if not math.isfinite(v)]
    if bad:
        fail(f"evaluate, center noiseGen: non-finite {bad}")
    s = metrics.bench_inference(opt, "center", iters=BENCH_ITERS, loaded=gen)
    print(f"evaluate, center noiseGen (nz {opt.nz}), {INFER_BATCHES} batches "
          f"of 64: psnr {q['psnr_db']:.3f} dB, hole_l2 {q['hole_l2']:.5f}; "
          f"bench_inference at batch 64: {s['clips_per_sec']:.1f} clips/s, "
          f"batch latency {s['batch_latency_ms']:.2f} ms on {smi}")
    del gen
    from concurrent.futures import ThreadPoolExecutor
    srv = InpaintServer(opt, "center", net, max_delay_ms=5.0)
    try:
        rs = np.random.RandomState(10)
        ctxs = [rs.randint(0, 256, (128, 128, 3), np.uint8)
                for _ in range(16)]
        zs = [rs.normal(size=opt.nz).astype(np.float32) if i % 2 else None
              for i in range(16)]

        def one(i):
            arrays = {"ctx": ctxs[i]}
            if zs[i] is not None:
                arrays["noise"] = zs[i]
            return post(srv.port, **arrays)
        with ThreadPoolExecutor(16) as pool:
            outs = list(pool.map(one, range(16)))
        n_diff = 0
        for i, (code, out) in enumerate(outs):
            code_solo, solo = one(i)
            if code != 200 or code_solo != 200:
                fail(f"noiseGen server: HTTP {code} / {code_solo}")
            n_diff += u8_levels("noiseGen server row against its solo "
                                "result", out, solo)
            if zs[i] is None:
                code_z, zero = post(srv.port, ctx=ctxs[i],
                                    noise=np.zeros(opt.nz, np.float32))
                if code_z != 200 or not np.array_equal(solo, zero):
                    fail("noiseGen server: a row without noise is not the "
                         "zero-noise result")
            else:
                code_o, other = post(srv.port, ctx=ctxs[i],
                                     noise=-3 * zs[i])
                if code_o != 200 or np.array_equal(solo, other):
                    fail("noiseGen server: the posted noise does not reach "
                         "the output")
        st = srv.stats()
        print(f"noiseGen center server, batch 64, 16 concurrent single-row "
              f"requests (8 with their own z): each row within one uint8 "
              f"level of its solo result ({n_diff} values differ); rows "
              f"without noise equal the zero-noise result; avg_fill "
              f"{st['avg_fill']:.3f} over {st['batches']} batches on {smi}")
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Phase 8: the multi-device paths.  The rank functions below run in the
# processes of a run_world world (parallel/launch.py), which loads this
# script under another name than __main__; the parent orchestrates.
# ---------------------------------------------------------------------------

PAR_TINY = dict(nef=8, ngf=8, ndf=8, wtl2=0.999, computeDtype="float32")
PAR_TOL = dict(metric_rtol=1e-4, metric_atol=1e-5, param_atol=4.1e-3,
               bn_rtol=1e-4, bn_atol=1e-5,
               # gradients (Adam's first moments) leaf by leaf, over the
               # leaf's largest value: a wrong reduction reads 1.0 or more,
               # two right f32 steps up to 3.3e-2 at a near-tie
               # (tests/test_torch_parallel.py says why)
               grad_rel=0.1)
PAR_WORLD_S = 300.0   # a world's wall-clock limit: a hung collective fails


def _rank_setup():
    """A rank's process: the repository importable, TF32 off as phase 1
    sets it."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def _reset_counts():
    from video_filler_tpu_torch.ops.cuda import fused_loss as fl
    for counts in (fl.LAUNCHES, fl.VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _counts():
    from video_filler_tpu_torch.ops.cuda import fused_loss as fl
    return {**fl.LAUNCHES, **fl.VARIANT_LAUNCHES}


def _numpy_sd(module):
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def _adam_mu(state):
    """Both nets' Adam first moments, (1 - beta1) times the gradient after
    one step, by parameter name (f32 numpy)."""
    return {net: {n: opt.state[p]["exp_avg"].float().cpu().numpy()
                  for n, p in module.named_parameters()}
            for net, module, opt in (("gen", state.gen, state.opt_g),
                                     ("disc", state.disc, state.opt_d))}


def par_tiny_step(spec, mesh_kind=None, device="cuda"):
    """One tiny f32 train step on ``device``: on this rank's mesh (rows
    and, on a seq mesh, frames of the global batch) when ``mesh_kind`` is
    set, else the one-process step.  Returns the metrics, the full
    (gathered) G and D state dicts and their Adam first moments."""
    torch = _rank_setup()
    from video_filler_tpu_torch.config import Opt
    from video_filler_tpu_torch.parallel import mesh as mesh_mod
    from video_filler_tpu_torch.parallel import temporal
    from video_filler_tpu_torch.parallel.distributed import data_rows
    from video_filler_tpu_torch.train import step as step_mod
    opt = Opt(device=device, **spec["opt"])
    regime = spec["regime"]
    mesh = None
    if mesh_kind == "seq":
        mesh = temporal.make_seq_mesh(spec["n_data"], spec["n_shard"])
    elif mesh_kind == "model":
        mesh = mesh_mod.make_mesh(spec["n_data"], spec["n_shard"])
    state = step_mod.init_train_state(opt, regime,
                                      torch.Generator().manual_seed(0), mesh)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in spec["batch"].items()}
    if mesh is not None:
        where = mesh_mod.coords(mesh)
        if where.shard_axis == "seq":
            batch = temporal.shard_sp_batch(where, batch)
        else:
            rows = data_rows(opt.batchSize, where.n_data, where.data_rank)
            batch = {k: v[rows.to(v.device)] for k, v in batch.items()}
    kw = {}
    if spec.get("noise") is not None:
        kw["noise"] = torch.from_numpy(spec["noise"]).to(device)
    metrics = step_mod.make_train_step(opt, regime, mesh=mesh)(state, batch,
                                                              **kw)
    metrics = {k: float(v) for k, v in metrics.items()}
    full = (mesh_mod.unsharded(state, mesh) if mesh is not None
            else contextlib.nullcontext())
    with full:
        return {"metrics": metrics, "gen": _numpy_sd(state.gen),
                "disc": _numpy_sd(state.disc), "mu": _adam_mu(state)}


def par_loop(args, name, steps, tmp, keep_gen=False):
    """``loop.main`` from ``tmp`` on this rank with the launch counts set
    to 0 just before and read just after; this rank's logged steps, its
    launches, the run's seconds and, with ``keep_gen``, the final G and
    both nets' Adam first moments."""
    torch = _rank_setup()
    from video_filler_tpu_torch.parallel import comm, distributed
    from video_filler_tpu_torch.train import loop
    rank = distributed.process_index()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _reset_counts()
        sync = torch.cuda.synchronize if torch.cuda.is_available() \
            else (lambda: None)
        sync()
        t0 = time.perf_counter()
        state = loop.main([*args, f"name={name}"])
        sync()
        seconds = time.perf_counter() - t0
        launches = _counts()
    finally:
        os.chdir(cwd)
    log = f"{name}.jsonl" if rank == 0 else f"{name}_p{rank}.jsonl"
    with open(os.path.join(tmp, "logs", log)) as f:
        recs = [json.loads(line) for line in f if '"step"' in line]
    gen = _numpy_sd(state.gen) if keep_gen else None
    mu = _adam_mu(state) if keep_gen else None
    return {"steps": recs[-steps:], "launches": launches,
            "seconds": seconds, "step": state.step, "gen": gen, "mu": mu,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if torch.cuda.is_available() else 0.0),
            "staged": dict(comm.HOST_STAGED),
            "backend": torch.distributed.get_backend()}


def par_world1(tmp, center, video3d, specs, device="cuda"):
    """Phase 8(a), the one rank of an NCCL world: the tiny f32 steps
    through the mesh code against the plain step in this process, then the
    full-width runs through ``loop.main``."""
    torch = _rank_setup()
    out = {"tiny": []}
    for spec in specs:
        out["tiny"].append((par_tiny_step(spec, "model", device),
                            par_tiny_step(spec, None, device)))
    out["center"] = par_loop([*center, "ntrain=192", "niter=1",
                              "checkpointEvery=1"], "par1_center", 3, tmp)
    out["center_resumed"] = par_loop(
        [*center, "ntrain=192", "niter=2", "checkpointEvery=5",
         "autoResume=1"], "par1_center", 3, tmp)
    out["video3d"] = par_loop([*video3d, "ntrain=128", "niter=1",
                               "checkpointEvery=5"], "par1_video3d", 2, tmp)
    out["backend"] = torch.distributed.get_backend()
    return out


def par_two_ranks(tmp, specs, dd_args, full_runs, device="cuda"):
    """Phase 8(b), one of two gloo ranks sharing cuda:0: the tiny f32 steps
    on their meshes, the tiny dataDevice DP-2 loop, then the full-width
    runs."""
    _rank_setup()
    out = {"tiny": [par_tiny_step(spec, spec["kind"], device)
                    for spec in specs],
           "dd": par_loop(dd_args, "par2_dd", 1, tmp, keep_gen=True),
           "full": {}}
    for name, args, steps in full_runs:
        out["full"][name] = par_loop(args, name, steps, tmp)
        gc.collect()
    return out


def _close_trees(label, got, ref, atol, rtol=0.0):
    import numpy as np
    worst = 0.0
    for k, r in ref.items():
        err = np.abs(got[k] - r)
        if bool((err > atol + rtol * np.abs(r)).any()):
            fail(f"{label}: {k} differs by {float(err.max()):.3e} (atol "
                 f"{atol}, rtol {rtol})")
        worst = max(worst, float(err.max()) if err.size else 0.0)
    return worst


def _grad_rel(label, got_mu, ref_mu, limit):
    """The largest difference of two runs' Adam first moments over each
    leaf's largest value; fails above ``limit``."""
    import numpy as np
    worst = 0.0
    for net, ref in ref_mu.items():
        for k, r in ref.items():
            rel = float(np.abs(got_mu[net][k] - r).max()
                        / max(float(np.abs(r).max()), 1e-30))
            if rel > limit:
                fail(f"{label}: {net} {k} gradient {rel:.3e} of its scale "
                     f"off the reference (limit {limit})")
            worst = max(worst, rel)
    return worst


def _check_tiny(label, got, ref):
    """A sharded tiny step against the one-process step: metrics, post-Adam
    parameters, BN running statistics, gradients (Adam's first moments) at
    the CPU suite's tolerances."""
    import math as m
    for k, v in ref["metrics"].items():
        if not m.isclose(got["metrics"][k], v, rel_tol=PAR_TOL["metric_rtol"],
                         abs_tol=PAR_TOL["metric_atol"]):
            fail(f"{label}: metric {k} {got['metrics'][k]} vs {v}")
    params, stats = 0.0, 0.0
    for net in ("gen", "disc"):
        bn = {k for k in ref[net] if "running_" in k}
        params = max(params, _close_trees(
            label, {k: got[net][k] for k in ref[net] if k not in bn},
            {k: ref[net][k] for k in ref[net] if k not in bn},
            PAR_TOL["param_atol"]))
        stats = max(stats, _close_trees(
            label, {k: got[net][k] for k in bn}, {k: ref[net][k] for k in bn},
            PAR_TOL["bn_atol"], PAR_TOL["bn_rtol"]))
    grads = _grad_rel(label, got["mu"], ref["mu"], PAR_TOL["grad_rel"])
    return params, stats, grads


def _same_replicas(label, outs):
    import numpy as np
    for net in ("gen", "disc"):
        for k, v in outs[0][net].items():
            if any(not np.array_equal(v, o[net][k]) for o in outs[1:]):
                fail(f"{label}: the replicas differ in {net} {k}")


def _check_run(label, res, steps, grad_accum=1):
    """A full-width run on one rank: every metric finite, each loss kernel
    launched steps x gradAccum times per direction, all on the row path."""
    from video_filler_tpu_torch.train.step import METRIC_KEYS
    if len(res["steps"]) < steps:
        fail(f"{label}: logged {len(res['steps'])} steps, expected {steps}")
    for r in res["steps"]:
        bad = [k for k in METRIC_KEYS if not math.isfinite(r[k])]
        if bad:
            fail(f"{label}: non-finite metrics {bad}")
    n = res["launches"]
    per_dir = steps * grad_accum
    if n["fwd"] != per_dir or n["bwd"] != per_dir or n["generic"] \
            or n["row"] != 2 * per_dir:
        fail(f"{label}: loss kernels launched {n} in {steps} steps of "
             f"{grad_accum} microbatches: expected {per_dir} per direction, "
             "all on the row path")


def par_specs(np):
    """The tiny f32 cases of phase 8: (name, spec) with the global batch
    made from a seed."""
    rs = np.random.RandomState(8)
    center = {"real": rs.uniform(-1, 1, (8, 128, 128, 3)).astype(np.float32)}
    c = dict(PAR_TINY, nBottleneck=16, batchSize=8, overlapPred=4)
    v3 = dict(PAR_TINY, nBottleneck=64, predLen=4, batchSize=4,
              weight_nomask=0.05, video3dLevels=3, fineSize=32)
    mask3 = np.zeros((4, 1, 32, 32, 1), np.float32)
    mask3[:, :, 8:20, 8:20] = 1.0
    clip = {"real": rs.uniform(-1, 1, (4, 4, 32, 32, 3)).astype(np.float32),
            "mask": mask3}
    noise = rs.normal(size=(8, 1, 1, 5)).astype(np.float32)
    return [
        ("DP-2 center", dict(opt=c, regime="center", kind="model", n_data=2,
                             n_shard=1, batch=center)),
        ("TP-2 center", dict(opt=c, regime="center", kind="model", n_data=1,
                             n_shard=2, batch=center)),
        ("TP-2 center noiseGen", dict(opt=dict(c, noiseGen=True, nz=5),
                                      regime="center", kind="model",
                                      n_data=1, n_shard=2, batch=center,
                                      noise=noise)),
        ("SP-2 video3d", dict(opt=v3, regime="video3d", kind="seq",
                              n_data=1, n_shard=2, batch=clip)),
    ]


def par_checkpoints(torch, Opt, from_args, split_regime, step_mod, run,
                    tmp):
    """The checkpoints phase 8(c) exports: phase 5's video, video3d and
    center noiseGen ones."""
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    nets = {"video": (run["video"], j("checkpoints", "video_2_state.npz")),
            "video3d": (run["video3d"],
                        j("checkpoints", "video3d_1_state.npz")),
            "center noiseGen": (run["options"]["center_noiseGen"][1],
                                j("checkpoints",
                                  "center_noiseGen_1_state.npz"))}
    for label, (_, path) in nets.items():
        if not os.path.exists(path):
            fail(f"phase 8: phase 5 wrote no {label} checkpoint {path}")
    return {label: (split_regime(args)[0], from_args(split_regime(args)[1]),
                    path) for label, (args, path) in nets.items()}


def export_checks(torch, np, nets, smi):
    """Phase 8(c): each generator exported at batch 64 on the card, the
    .pt2 reloaded, its uint8 output against the server function's and the
    eager module's; ms per batch of both."""
    from video_filler_tpu_torch.eval import export_pt2
    from video_filler_tpu_torch.eval.common import load_generator
    from video_filler_tpu_torch.serve import InpaintServer
    rs = np.random.RandomState(12)
    for label, (regime, opt, path) in nets.items():
        t0 = time.perf_counter()
        gen = load_generator(opt, regime, path, "cuda")
        ep = export_pt2.export_generator(opt, regime, path, gen)
        pt2 = path.replace("_state.npz", ".pt2")
        torch.export.save(ep, pt2)
        seconds = time.perf_counter() - t0
        g = torch.export.load(pt2).module()
        args = export_pt2.example_inputs(opt, regime, torch.device("cuda"))
        ctx = torch.from_numpy(rs.randint(0, 256, tuple(args[0].shape),
                                          dtype=np.uint8)).cuda()
        noise = tuple(torch.from_numpy(rs.normal(size=tuple(a.shape))
                                       .astype(np.float32)).cuda()
                      for a in args[1:])
        eager = export_pt2.ServedGenerator(
            gen, opt.predLen if regime == "video3d" else None)
        with torch.inference_mode():
            got = g(ctx, *noise)
            ref = eager(ctx, *noise)
            exp_ms = cuda_ms(lambda: g(ctx, *noise), 10)
            eager_ms = cuda_ms(lambda: eager(ctx, *noise), 10)
        del eager, gen, g, ep
        srv = InpaintServer(opt, regime, path, max_delay_ms=5.0)
        try:
            if not torch.equal(got, ref):
                fail(f"export {label}: the .pt2 output differs from the "
                     f"eager G's ({int((got != ref).sum())} values)")
            ctx_np = ctx.cpu().numpy()
            if regime == "center":
                served = srv._serve_fn(
                    ctx_np, np.ones(ctx_np.shape[:3] + (1,), np.uint8),
                    noise[0].cpu().numpy())
                # the server pastes the hole inside the overlap ring
                lo = 32 + opt.overlapPred
                hi = 96 - opt.overlapPred
                op = opt.overlapPred
                n_diff = u8_levels(
                    f"export {label} against the server",
                    got.cpu().numpy()[:, op:64 - op, op:64 - op],
                    served[:, lo:hi, lo:hi])
            else:
                served = srv._serve_fn(
                    ctx_np, np.ones(ctx_np.shape[:3] + (1,), np.uint8))
                n_diff = u8_levels(f"export {label} against the server",
                                   got.cpu().numpy(), served)
        finally:
            srv.close()
        print(f"export {label}: {os.path.basename(pt2)} "
              f"({os.path.getsize(pt2) / 1e6:.1f} MB) written in "
              f"{seconds:.1f} s; reloaded output equals the eager G's "
              f"exactly and is within one uint8 level of the server "
              f"function's ({n_diff} values differ); batch 64: exported "
              f"{exp_ms:.2f} ms, eager {eager_ms:.2f} ms per batch on {smi}")


def parallel_phase(torch, np, fl, Opt, from_args, split_regime, step_mod,
                   loop, run, tmp, smi):
    """Phase 8: (a) an NCCL world of one rank, (b) two gloo ranks sharing
    the card, (c) dataParallel serving refused on one card and the
    torch.export artifacts.  Returns the loss-kernel launches per rank of
    the full-width parallel runs."""
    from video_filler_tpu_torch.data.synthetic import make_image_folder
    from video_filler_tpu_torch.parallel.launch import run_world
    from video_filler_tpu_torch.serve import InpaintServer
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    specs = par_specs(np)
    launches = {}

    # (a) the production backend at world 1
    t0 = time.perf_counter()
    world1 = dict(specs[0][1], n_data=1, n_shard=1)   # center
    one = run_world(1, par_world1, (tmp, run["center_args"], run["video3d"],
                                    [world1]),
                    backend="nccl", timeout_s=PAR_WORLD_S)[0]
    for got, ref in one["tiny"]:
        p, s, g = _check_tiny("NCCL world 1, tiny center", got, ref)
        for k, v in ref["metrics"].items():
            if not math.isclose(got["metrics"][k], v, rel_tol=1e-5,
                                abs_tol=1e-7):
                fail(f"NCCL world 1: metric {k} {got['metrics'][k]} vs the "
                     f"plain step's {v} (rtol 1e-5)")
        print(f"(a) NCCL world 1: the tiny f32 center step through the mesh "
              f"code equals the plain step on the card (metrics rtol 1e-5; "
              f"params max|diff| {p:.2e}, BN stats {s:.2e}; gradients "
              f"{g:.2e} of a leaf's scale <= 0.1)")
    for name, steps in (("center", 3), ("center_resumed", 3),
                        ("video3d", 2)):
        res = one[name]
        _check_run(f"NCCL {name}", res, steps)
        launches[f"nccl1_{name}"] = {"rank0": res["launches"]}
        print(f"(a) NCCL world 1, {name}: {steps} full-width bf16 steps "
              f"through train.loop.main in {res['seconds']:.1f} s (backend "
              f"{res['backend']}), last step {1e3 * res['steps'][-1]['time']:.1f}"
              f" ms (first {1e3 * res['steps'][0]['time']:.1f} ms); launches "
              f"{res['launches']}; errG_l2 "
              + " ".join(f"{r['errG_l2']:.4f}" for r in res["steps"]))
    if one["center_resumed"]["step"] != 6:
        fail(f"NCCL center resume ended at step "
             f"{one['center_resumed']['step']}, expected 6")
    print(f"(a) took {time.perf_counter() - t0:.1f} s")

    # (b) two ranks on the one card: gloo, both on cuda:0
    t0 = time.perf_counter()
    make_image_folder(j("par_data"), n=16, h=140, w=150)
    dd_args = ["regime=center", "device=cuda", "batchSize=8",
               "nBottleneck=16", f"DATA_ROOT={j('par_data')}", "loadSize=0",
               "overlapPred=4", "ntrain=8", "niter=1", "checkpointEvery=5",
               "display=0", "dataDevice=1", "manualSeed=5", "nThreads=1",
               *[f"{k}={v}" for k, v in PAR_TINY.items()]]
    full_runs = [
        ("par2_dp_center", [*run["center_args"], "ntrain=128"], 2),
        ("par2_tp_center", [*run["center_args"], "ntrain=128",
                            "modelParallel=2"], 2),
        ("par2_sp_video3d", [*run["video3d"], "ntrain=128", "niter=1",
                             "checkpointEvery=5", "seqParallel=2"], 2),
    ]
    two = run_world(2, par_two_ranks,
                    (tmp, [s for _, s in specs], dd_args, full_runs),
                    backend="gloo", device="cuda:0", timeout_s=PAR_WORLD_S)
    for i, (label, spec) in enumerate(specs):
        ref = par_tiny_step(spec)
        outs = [o["tiny"][i] for o in two]
        _same_replicas(label, outs)
        p, s, g = _check_tiny(label, outs[0], ref)
        print(f"(b) {label}, two gloo ranks on cuda:0, tiny f32: equals the "
              f"one-process step on the card (metrics rtol 1e-4; params "
              f"max|diff| {p:.2e} <= 4.1e-3; BN stats {s:.2e}; gradients "
              f"{g:.2e} of a leaf's scale <= 0.1); replicas bitwise equal")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        ref_dd = loop.main([*dd_args, "name=par1_dd"])
    finally:
        os.chdir(cwd)
    ref_gen = _numpy_sd(ref_dd.gen)
    for o in two:
        _check_run("dataDevice DP-2", o["dd"], 1)
    worst = _close_trees("dataDevice DP-2 against one process",
                         two[0]["dd"]["gen"], ref_gen, PAR_TOL["param_atol"])
    grads = _grad_rel("dataDevice DP-2 against one process",
                      two[0]["dd"]["mu"], _adam_mu(ref_dd),
                      PAR_TOL["grad_rel"])
    if any(not np.array_equal(two[0]["dd"]["gen"][k], two[1]["dd"]["gen"][k])
           for k in ref_gen):
        fail("dataDevice DP-2: the replicas differ")
    print(f"(b) dataDevice DP-2 center, tiny f32, 1 step through "
          f"train.loop.main: G within {worst:.2e} of the one-process run "
          f"(atol 4.1e-3), Adam first moments {grads:.2e} of a leaf's "
          f"scale (<= 0.1), replicas bitwise equal")
    for name, _, steps in full_runs:
        ms = []
        for rank, o in enumerate(two):
            res = o["full"][name]
            _check_run(f"{name} rank {rank}", res, steps)
            ms.append(1e3 * res["steps"][-1]["time"])
        launches[name] = {f"rank{r}": o["full"][name]["launches"]
                          for r, o in enumerate(two)}
        res = two[0]["full"][name]
        print(f"(b) {name}: {steps} full-width bf16 steps per rank through "
              f"train.loop.main in {res['seconds']:.1f} s; first step "
              f"{1e3 * res['steps'][0]['time']:.1f} ms, last step "
              f"{' / '.join(f'{m:.1f}' for m in ms)} ms (rank 0 / 1; two "
              f"ranks sharing one card: not a multi-GPU speed); peak "
              f"{res['peak_gb']:.2f} GB per rank; launches per rank "
              f"{launches[name]}; errG_l2 "
              + " ".join(f"{r['errG_l2']:.4f}" for r in res["steps"]))
    staged = two[0]["full"]["par2_sp_video3d"]["staged"]
    print(f"(b) gloo send/recv calls on CUDA tensors staged through pinned "
          f"host buffers, on rank 0 over its runs: {staged['send_recv']} "
          f"(gloo runs the other collectives on CUDA tensors itself; a raw "
          f"CUDA send/recv kills the rank: parallel/probe.py)")
    print(f"(b) took {time.perf_counter() - t0:.1f} s")

    # (c) serving and export
    t0 = time.perf_counter()
    nets = par_checkpoints(torch, Opt, from_args, split_regime, step_mod,
                           run, tmp)
    regime, vopt, vpath = nets["video"]
    try:
        InpaintServer(vopt.replace(dataParallel=2), regime, vpath)
    except SystemExit as e:
        if "device_count() is 1" not in str(e):
            fail(f"dataParallel=2 on one card: unexpected message {e}")
        print(f"(c) serve dataParallel=2 on one card exits: {e}")
    else:
        fail("serve dataParallel=2 on one card did not exit")
    export_checks(torch, np, nets, smi)
    print(f"(c) took {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "video_filler_tpu_torch")):
        fail("run from a checkout of the repository (video_filler_tpu_torch/ "
             "not found beside this script)")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    profile = "--profile" in sys.argv[1:]

    import numpy as np

    from video_filler_tpu_torch.config import Opt, from_args, split_regime
    from video_filler_tpu_torch.data import native, synthetic
    from video_filler_tpu_torch.data.synthetic import make_image_folder
    from video_filler_tpu_torch.ops import losses, masks
    from video_filler_tpu_torch.ops.cuda import build
    from video_filler_tpu_torch.ops.cuda import fused_loss as fl
    from video_filler_tpu_torch.train import loop
    from video_filler_tpu_torch.train import step as step_mod

    phase("1 device")
    jax_loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "video_filler_tpu"))
    if jax_loaded:
        fail(f"the port's imports loaded {jax_loaded[:8]}: it must import "
             f"nothing of jax or of the JAX package")
    print("sys.modules after the port's imports: no jax, no video_filler_tpu")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device: "
          f"{kind}; count {torch.cuda.device_count()}")
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    phase("2 build")
    t0 = time.perf_counter()
    so, log = build.build("fused_loss")
    print(f"built {os.path.relpath(so, HERE)} with {build.nvcc_path()} "
          f"{' '.join(build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line or "spill" in line:
            print("  " + line.strip())
    t0 = time.perf_counter()
    if native.available():
        print(f"built {os.path.relpath(native.library_path(), HERE)} with "
              f"g++ {' '.join(native.GXX_FLAGS)} in "
              f"{time.perf_counter() - t0:.1f} s: the host samplers of "
              "phases 5-7 decode natively (data/native.py)")
    else:
        print(f"vf_native unavailable ({native.unavailable_reason()}): the "
              "host samplers of phases 5-7 take the Python decode")

    phase("3 kernels vs plain")
    smi_line = smi.splitlines()[0]
    knum = kernel_checks(torch, fl, losses, masks, smi_line)
    library_check(torch, fl, losses, masks)

    phase("4 card vs CPU parity")
    parity_check(torch, np, Opt, step_mod)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase("5 main path")
        run = main_path(torch, fl, loop, step_mod, synthetic,
                        make_image_folder, tmp)

        phase("6 timing")
        timing(torch, step_mod, from_args, split_regime, run, knum, smi_line,
               profile)
        gc.collect()
        data_device_timing(torch, np, step_mod, loop, from_args,
                           split_regime, run, smi_line)
        gc.collect()

        phase("7 inference")
        inference(torch, np, fl, Opt, from_args, split_regime, step_mod,
                  run["video"], run["video3d"],
                  run["options"]["center_noiseGen"][1], run["center_args"],
                  run["dd_center"], tmp, smi_line)
        gc.collect()
        torch.cuda.empty_cache()

        phase("8 parallel")
        par_launches = parallel_phase(torch, np, fl, Opt, from_args,
                                      split_regime, step_mod, loop, run, tmp,
                                      smi_line)

    rel = "video_filler_tpu_torch/csrc/fused_loss.cu"
    ref = "video_filler_tpu/ops/pallas/fused_loss.py"
    main_geom = knum["video bf16"]
    err = {k: max(v[f"{k}_err"] for v in knum.values())
           for k in ("fwd", "bwd")}

    def numbers(geom, k):
        return {"ms": geom[k], "plain_ms": geom[f"{k}_plain"],
                "bound_ms": geom[f"{k}_bound"], "cold_ms": geom[f"{k}_cold"],
                "share": geom[f"{k}_bound"] / geom[f"{k}_cold"],
                "variant": geom["variant"], "index32": geom["index32"],
                "max_abs_err": geom[f"{k}_err"]}

    print(json.dumps({"kernels": [
        {"name": f"fused_weighted_mse_{k}", "route": "cuda", "source": rel,
         "replaces": f"{ref}:{line}", **numbers(main_geom, k),
         "launches": run["launches"][k],
         "launches_video3d": run["launches_video3d"][k],
         "launches_parallel": {
             name: {rank: n[k] for rank, n in ranks.items()}
             for name, ranks in par_launches.items()},
         "max_abs_err": err[k], "bound_by": "bytes", "library_ms": None,
         "geometries": {name: numbers(geom, k) for name, geom in knum.items()
                        if f"{k}_cold" in geom}}
        for k, line in (("fwd", 58), ("bwd", 69))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
