"""What the measurement tools share: their ``key=value`` options, the
device they run on and its description, and a timer."""

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


def describe(device: torch.device) -> str:
    """The device a tool's numbers come from: on the card its name and
    power limit as ``nvidia-smi`` prints them, and the cuDNN settings the
    tool runs under; on the CPU a line saying the times are the host's."""
    if device.type != "cuda":
        return ("device: cpu (host times, not a device metric; memory not "
                "measured)")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    return (f"device: {torch.cuda.get_device_name(device)}; {smi}; torch "
            f"{torch.__version__} cuda {torch.version.cuda}; cudnn.benchmark "
            f"{torch.backends.cudnn.benchmark}, cudnn.allow_tf32 "
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
