#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is non-zero:
  1. device   -- the card's name and power limit; TF32 set explicitly.
  2. build    -- nvcc builds video_filler_tpu_torch/csrc/fused_loss.cu for
                 sm_90a; prints the seconds and ptxas's register report.
  3. kernels  -- the fused weighted-MSE kernels against their plain PyTorch
                 versions on the card: the center shape (64,64,64,3) with
                 (1,64,64,1) ring weights in f32 and with bf16 pred, and a
                 ragged (3,7,9,5) with strided operands.  Forward rtol 1e-5;
                 backward rtol 1e-6 in f32, one bf16 ulp for bf16 pred;
                 two forwards bitwise equal.  Times kernel and plain version.
  4. parity   -- one tiny-width f32 train step on the card against the same
                 step on the CPU (the CPU port is held against the JAX
                 package by tests/test_torch_*.py).
  5. main     -- ``video_filler_tpu_torch.train.loop.main`` at full width
                 (nef=ngf=ndf=64, nBottleneck=4000, fineSize=128, batch 64,
                 bf16) for 5 steps on a synthetic image folder; every logged
                 metric finite, each loss kernel launched >= 5 times.
  6. timing   -- 20 steps on one device-resident batch: ms/step, clips/s.
     (--profile adds a torch.profiler table of device time by kernel.)
Then one JSON line of the kernels' numbers, and as the last line
{"ok": true, "device": {...}}.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FULL_WIDTH_ARGS = [
    "regime=center", "device=cuda", "batchSize=64", "nef=64", "ngf=64",
    "ndf=64", "nBottleneck=4000", "fineSize=128", "wtl2=0.999",
    "overlapPred=4", "computeDtype=bfloat16", "niter=1", "ntrain=320",
    "display=0", "checkpointEvery=2", "manualSeed=1", "nThreads=4",
    "name=chip_smoke",
]
MAIN_STEPS = 5
TIMED_STEPS = 20


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
    summed from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in device_rows(prof))
    return total_us / 1e3 / iters


def device_rows(prof):
    """The trace's device activities (kernels, copies, memsets), without
    the annotation ranges that span them."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


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


def kernel_checks(torch, fl, losses, masks):
    """Phase 3: returns the numbers for the result line (center, bf16)."""
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
    gbar = torch.tensor(1.7, device=dev)
    cases = [
        ("center f32", pred_c, target, ring),
        ("center bf16", pred_c.bfloat16(), target, ring),
        ("ragged f32", pred_r, target_r, w_r),
        ("ragged bf16", pred_r.bfloat16(), target_r, w_r),
    ]
    numbers = {}
    for name, p, t, w in cases:
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
        print(f"{name:12s} shape {tuple(p.shape)} fwd max|err| "
              f"{fwd_err:.3e}  bwd max|err| {bwd_err:.3e}  bitwise-repeat ok")
        if name.startswith("center"):
            calls = {
                "fwd": lambda: fl.launch_forward(p, t, w),
                "fwd_plain": lambda: fl.weighted_mse_reference(p, t, w),
                "bwd": lambda: fl.launch_backward(p, t, w, gbar),
                "bwd_plain": lambda: fl.weighted_mse_grad_reference(
                    p, t, w, gbar),
            }
            # Device time from the trace; the event time between 200
            # back-to-back calls is bounded by the host's launch rate.
            dev = {k: device_ms(f, 50) for k, f in calls.items()}
            wall = {k: cuda_ms(f, 200) for k, f in calls.items()}
            for k in calls:
                print(f"{name:12s} {k:9s} device {dev[k] * 1e3:7.2f} us/call"
                      f"  back-to-back {wall[k] * 1e3:7.2f} us/call")
            if min(dev.values()) <= 0:
                fail(f"{name}: the profiler recorded no device time")
            numbers[name] = dict(dev, fwd_err=fwd_err, bwd_err=bwd_err)
    return numbers["center bf16"]


def parity_check(torch, Opt, step_mod):
    """Phase 4: tiny f32 step, card against CPU, from the same init."""
    import numpy as np
    kw = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=4, wtl2=0.999,
              overlapPred=4, computeDtype="float32")
    rs = np.random.RandomState(3)
    real = torch.from_numpy(rs.rand(4, 128, 128, 3).astype(np.float32) * 2 - 1)
    out = {}
    for device in ("cpu", "cuda"):
        opt = Opt(device=device, **kw)
        state = step_mod.init_train_state(opt, "center",
                                          torch.Generator().manual_seed(5))
        step = step_mod.make_train_step(opt, "center")
        metrics = step(state, {"real": real.to(device)})
        out[device] = ({k: v.item() for k, v in metrics.items()},
                       [p.detach().cpu() for p in state.gen.parameters()])
    for k, v in out["cpu"][0].items():
        got = out["cuda"][0][k]
        if not math.isclose(got, v, rel_tol=1e-3, abs_tol=1e-6):
            fail(f"parity: {k} on the card {got} vs CPU {v}")
    # First Adam step ~ lr*sign(g): a tiny gradient can flip sign, worth
    # 2*lr_G = 4e-3 (the JAX suite's bound for the same comparison).
    worst = max(float((a - b).abs().max())
                for a, b in zip(out["cuda"][1], out["cpu"][1]))
    if worst > 4.1e-3:
        fail(f"parity: G params after one step differ by {worst}")
    print(f"card vs CPU, tiny f32 step: metrics within rtol 1e-3 "
          f"({json.dumps(out['cuda'][0])}); G params max|diff| {worst:.2e}")


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "video_filler_tpu_torch")):
        fail("run from a checkout of the repository (video_filler_tpu_torch/ "
             "not found beside this script)")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    profile = "--profile" in sys.argv[1:]

    from video_filler_tpu_torch.config import Opt, from_args, split_regime
    from video_filler_tpu_torch.data.synthetic import make_image_folder
    from video_filler_tpu_torch.ops import losses, masks
    from video_filler_tpu_torch.ops.cuda import build
    from video_filler_tpu_torch.ops.cuda import fused_loss as fl
    from video_filler_tpu_torch.train import loop
    from video_filler_tpu_torch.train import step as step_mod

    phase("1 device")
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

    phase("3 kernels vs plain")
    knum = kernel_checks(torch, fl, losses, masks)

    phase("4 card vs CPU parity")
    parity_check(torch, Opt, step_mod)

    phase("5 main path")
    args = list(FULL_WIDTH_ARGS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        make_image_folder(os.path.join(tmp, "data"), n=64 * MAIN_STEPS,
                          h=160, w=200)
        args.append(f"DATA_ROOT={os.path.join(tmp, 'data')}")
        for k in fl.LAUNCHES:
            fl.LAUNCHES[k] = 0
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            state = loop.main(args)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launches = dict(fl.LAUNCHES)
        with open(os.path.join(tmp, "logs", "chip_smoke.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "step" in r]
    if len(steps) != MAIN_STEPS:
        fail(f"main path logged {len(steps)} steps, expected {MAIN_STEPS}")
    for r in steps:
        bad = [k for k in step_mod.METRIC_KEYS
               if not math.isfinite(r[k])]
        if bad:
            fail(f"non-finite metrics {bad} at step {r['step']}")
    if launches["fwd"] < MAIN_STEPS or launches["bwd"] < MAIN_STEPS:
        fail(f"loss kernels launched {launches} times in {MAIN_STEPS} steps")
    n_params = sum(p.numel() for p in state.gen.parameters())
    print(f"{MAIN_STEPS} full-width steps in {t_main:.1f} s (first-step "
          f"cudnn autotune included); G params {n_params / 1e6:.1f} M; "
          f"kernel launches {launches}")
    print("errG_l2 by step: "
          + " ".join(f"{r['errG_l2']:.4f}" for r in steps))

    phase("6 timing")
    opt = from_args(split_regime(args)[1])
    step_fn = step_mod.make_train_step(opt, "center")
    preprocess = step_mod.make_preprocess(opt, "center")
    g = torch.Generator(device="cuda").manual_seed(0)
    raw = torch.randint(0, 256, (64, 128, 128, 3), generator=g,
                        dtype=torch.uint8, device="cuda")
    batch = preprocess({"raw": raw}, torch.Generator().manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step_fn(state, batch), TIMED_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"center step, batch 64, full width, bf16: {step_ms:.2f} ms/step, "
          f"{64 * 1e3 / step_ms:.1f} clips/s, peak memory {peak_gb:.2f} GB "
          f"on {smi.splitlines()[0]}")
    loss_share = (knum["fwd"] + knum["bwd"]) / step_ms
    print(f"loss kernels (fwd+bwd, device) "
          f"{(knum['fwd'] + knum['bwd']) * 1e3:.1f} us = "
          f"{100 * loss_share:.2f}% of the step")
    step_dev = device_ms(lambda: step_fn(state, batch), 5)
    print(f"device busy {step_dev:.2f} ms of each {step_ms:.2f} ms step: idle "
          f"share {100 * (1 - step_dev / step_ms):.1f}%")
    if profile:
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
        total = sum(e.self_device_time_total for e in rows)
        print(f"device activities over 5 steps: {total / 1e3:.2f} ms")
        for e in rows[:40]:
            print(f"{100 * e.self_device_time_total / total:6.2f}% "
                  f"{e.self_device_time_total / 5e3:8.3f} ms/step "
                  f"x{e.count // 5:<4d} {e.key[:110]}")

    rel = "video_filler_tpu_torch/csrc/fused_loss.cu"
    ref = "video_filler_tpu/ops/pallas/fused_loss.py"
    print(json.dumps({"kernels": [
        {"name": "fused_weighted_mse_fwd", "route": "cuda", "source": rel,
         "replaces": f"{ref}:58", "launches": launches["fwd"],
         "max_abs_err": knum["fwd_err"], "ms": knum["fwd"],
         "plain_ms": knum["fwd_plain"]},
        {"name": "fused_weighted_mse_bwd", "route": "cuda", "source": rel,
         "replaces": f"{ref}:69", "launches": launches["bwd"],
         "max_abs_err": knum["bwd_err"], "ms": knum["bwd"],
         "plain_ms": knum["bwd_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
