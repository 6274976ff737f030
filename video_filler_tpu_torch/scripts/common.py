"""What the measurement tools share: their ``key=value`` options, the
device they run on and its description, two timers and the device's busy
time."""

from __future__ import annotations

import os
import subprocess
import time

import torch

from video_filler_tpu_torch.config import Opt, resolve_device


def split_args(argv: list[str]) -> tuple[list[str], dict[str, str]]:
    """(positional words, ``key=value`` options) of a tool's arguments."""
    words = [a for a in argv if "=" not in a]
    opts = dict(a.split("=", 1) for a in argv if "=" in a)
    return words, opts


def smoke() -> bool:
    """``VF_SMOKE=1``: the tool's tiny configuration, for the CPU tests."""
    return os.environ.get("VF_SMOKE") == "1"


def tool_device(opts: dict[str, str]) -> torch.device:
    """``device=`` of the options (default the card); a card that is not
    there raises (config.resolve_device), never falls back to the CPU."""
    return resolve_device(Opt(device=opts.pop("device", "cuda")))


def card(device: torch.device) -> str:
    """What a tool's row names as its device: on the card its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints
    them; on the CPU that the numbers are the host's."""
    if device.type != "cuda":
        return "cpu (host times, not a device metric)"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def describe(device: torch.device) -> str:
    """The device a tool's numbers come from: on the card its name and
    power limit (``card``), and the cuDNN settings the tool runs under; on
    the CPU a line saying the times are the host's."""
    if device.type != "cuda":
        return ("device: cpu (host times, not a device metric; memory not "
                "measured)")
    return (f"device: {torch.cuda.get_device_name(device)}; {card(device)}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"cudnn.benchmark {torch.backends.cudnn.benchmark}, "
            f"cudnn.allow_tf32 "
            f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, iters: int, device: torch.device, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` after ``warmup`` calls (cuDNN times
    its algorithms on the first): on the card CUDA events around ``iters``
    back-to-back calls, on the CPU the host clock."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def wall_ms(fn, iters: int, device: torch.device) -> float:
    """Milliseconds per call of ``fn(i)``, i = 0..iters-1, on the host
    clock between two synchronizations of the card: the time a caller
    waits, host dispatch included (where the host holds the card back,
    CUDA events around the calls would show only the device's share).
    The caller warms up first."""
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def device_rows(prof) -> list:
    """A torch.profiler trace's device activities (kernels, copies,
    memsets), without the annotation ranges that span them."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def device_busy_ms(fn, iters: int) -> float:
    """Milliseconds of device work per call of ``fn(i)`` on the card: the
    kernels', copies' and memsets' own times summed from a torch.profiler
    trace of ``iters`` calls.  A trace with no device activity (CUPTI now
    and then delivers an empty one) is taken again, up to twice."""
    from torch.profiler import ProfilerActivity, profile
    total_us = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in device_rows(prof))
        if total_us > 0:
            break
    return total_us / 1e3 / iters
