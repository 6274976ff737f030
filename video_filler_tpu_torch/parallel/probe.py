"""What the collective backends do with two ranks on one CUDA card.

    python -m video_filler_tpu_torch.parallel.probe

Two questions decide how two ranks share a card (chip_smoke.py phase 8
and parallel/comm.py):

* does NCCL run an all_reduce with both ranks on ``cuda:0``?
* does gloo run each raw collective on CUDA tensors, without the host
  staging of parallel/comm.py?

Each question runs in a world of its own (``run_world``), so a rank that
dies answers one question only.  One line per question: ``ok`` with the
values checked against the expected ones, or the error's telling lines.
Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import os
import sys

GLOO_OPS = ("all_reduce", "broadcast", "all_gather_into_tensor",
            "reduce_scatter_tensor", "batch_isend_irecv")


def nccl_all_reduce() -> list[float]:
    """Each rank's ``rank + 1`` summed over the world with NCCL."""
    import torch
    import torch.distributed as dist
    t = torch.full((4,), float(dist.get_rank() + 1), device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return t.tolist()


def gloo_raw(op: str) -> list[tuple[str, list[float], list[float]]]:
    """One raw gloo collective ``op`` on CUDA tensors of two ranks, in f32
    then bf16: (dtype, what this rank got, what it should get) each."""
    import torch
    import torch.distributed as dist
    r = dist.get_rank()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((4,), float(r + 1), device="cuda", dtype=dtype)
        if op == "all_reduce":
            dist.all_reduce(x)
            got, want = x, [3.0] * 4
        elif op == "broadcast":
            dist.broadcast(x, 0)
            got, want = x, [1.0] * 4
        elif op == "all_gather_into_tensor":
            got = torch.empty(8, device="cuda", dtype=dtype)
            dist.all_gather_into_tensor(got, x)
            want = [1.0] * 4 + [2.0] * 4
        elif op == "reduce_scatter_tensor":
            src = torch.arange(8, device="cuda", dtype=dtype) * (r + 1)
            got = torch.empty(4, device="cuda", dtype=dtype)
            dist.reduce_scatter_tensor(got, src)
            want = [3.0 * v for v in range(4 * r, 4 * r + 4)]
        elif op == "batch_isend_irecv":
            got = torch.empty(4, device="cuda", dtype=dtype)
            ops = [dist.P2POp(dist.isend, x, 1 - r),
                   dist.P2POp(dist.irecv, got, 1 - r)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            want = [float(2 - r)] * 4
        else:
            raise ValueError(op)
        out.append((str(dtype), got.float().tolist(), want))
    return out


def _telling(err: BaseException, n: int = 6) -> str:
    """The lines of a world's error that name the cause."""
    keys = ("Duplicate", "Error", "error", "Exception", "invalid", "what()",
            "Bad address")
    lines = [ln.strip() for ln in str(err).splitlines()
             if any(k in ln for k in keys)]
    return " | ".join(dict.fromkeys(lines[-n:])) or str(err)[-400:]


def _ask(label: str, fn, args: tuple, backend: str) -> None:
    from video_filler_tpu_torch.parallel.launch import run_world
    try:
        outs = run_world(2, fn, args, backend=backend, device="cuda:0",
                         timeout_s=90)
    except (RuntimeError, TimeoutError) as e:
        print(f"{label}: FAILED: {type(e).__name__}: {_telling(e)}",
              flush=True)
        return
    if fn is nccl_all_reduce:
        good = all(o == [3.0] * 4 for o in outs)
        print(f"{label}: " + ("ok, values as expected" if good else
                              f"WRONG values {outs}"), flush=True)
        return
    bad = [(dtype, got) for o in outs for dtype, got, want in o
           if got != want]
    print(f"{label}: " + (f"WRONG values {bad}" if bad else
                          "ok, f32 and bf16 values as expected"), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe: CUDA is not available")
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    _ask("nccl, two ranks on cuda:0, all_reduce", nccl_all_reduce, (),
         "nccl")
    for op in GLOO_OPS:
        _ask(f"gloo, two ranks on cuda:0, raw {op} on CUDA tensors",
             gloo_raw, (op,), "gloo")


if __name__ == "__main__":
    main()
