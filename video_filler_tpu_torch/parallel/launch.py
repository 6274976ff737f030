"""``run_world``: run one function in N processes that form a
``torch.distributed`` world on this host.

Each rank is a fresh Python process (``subprocess``, not ``fork``: a CUDA
context does not survive a fork) that gets torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) on a free localhost port, sets one intra-op thread,
initialises the process group (parallel/distributed.py ``initialize``),
calls ``fn(*args)`` and pickles its result to a file.  The parent returns
the results by rank, raises with the failing rank's traceback and log tail
when a rank fails, and kills the whole world when it outlives
``timeout_s``: a collective that waits for a dead peer fails its caller
instead of hanging it.

``fn`` must be a function at the top level of a module on ``sys.path``
or of the script being run (which the child then loads under another name
than ``__main__``, as multiprocessing's spawn does); ``args`` and the
result must pickle.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

_CHILD = ("import sys, pickle; sys.path[:0] = pickle.loads(bytes.fromhex("
          "sys.argv[2])); from video_filler_tpu_torch.parallel.launch "
          "import _child_main; _child_main(sys.argv[1])")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_main(spec_path: str) -> None:
    """One rank: the process group, ``fn``, its pickled result (or the
    traceback) in the rank's result file."""
    import traceback

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = spec["out"]
    try:
        fn = spec["fn"]
        if isinstance(fn, tuple):       # (script path, function name)
            import importlib.util
            mod_spec = importlib.util.spec_from_file_location(
                "__vf_world_main__", fn[0])
            module = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(module)
            fn = getattr(module, fn[1])
        import torch
        torch.set_num_threads(1)
        from video_filler_tpu_torch.parallel import distributed
        distributed.initialize(backend=spec["backend"],
                               device=spec["device"],
                               timeout_s=spec["timeout_s"])
        result = ("ok", fn(*spec["args"]))
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        result = ("error", f"{type(e).__name__}: {e}\n"
                           f"{traceback.format_exc()}")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    try:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 -- teardown after the result is out
        pass
    sys.stdout.flush()
    # A failed rank exits at once: its peers' collectives then fail or
    # time out, and the parent kills them.
    os._exit(0 if result[0] == "ok" else 1)


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_world(n: int, fn, args: tuple = (), backend: str = "gloo",
              device: str | None = None, timeout_s: float = 120.0) -> list:
    """Run ``fn(*args)`` on ranks 0..n-1 of a new world; returns the
    results in rank order.

    backend: ``"gloo"`` or ``"nccl"``.  device: each rank's device --
    ``"cpu"``, ``"cuda:0"`` for every rank (two ranks sharing one card,
    gloo), or None for ``cuda:{LOCAL_RANK}``.  timeout_s: the wall-clock
    limit of the whole world, after which every rank is killed and
    TimeoutError raised."""
    work = tempfile.mkdtemp(prefix="vf_world_")
    port = free_port()
    paths = [p for p in sys.path if p and os.path.isdir(p)]
    base_env = dict(os.environ, MASTER_ADDR="localhost",
                    MASTER_PORT=str(port), WORLD_SIZE=str(n),
                    LOCAL_WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    if getattr(fn, "__module__", None) == "__main__":
        fn = (os.path.abspath(sys.modules["__main__"].__file__),
              fn.__qualname__)
    procs, logs, outs = [], [], []
    try:
        for rank in range(n):
            out = os.path.join(work, f"rank{rank}.pkl")
            spec = os.path.join(work, f"spec{rank}.pkl")
            with open(spec, "wb") as f:
                pickle.dump({"fn": fn, "args": tuple(args), "out": out,
                             "backend": backend, "device": device,
                             "timeout_s": timeout_s}, f)
            log = os.path.join(work, f"rank{rank}.log")
            rank_env = dict(base_env, RANK=str(rank), LOCAL_RANK=str(rank))
            with open(log, "w") as lf:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CHILD, spec,
                     pickle.dumps(paths).hex()],
                    env=rank_env, stdout=lf,
                    stderr=subprocess.STDOUT))
            logs.append(log)
            outs.append(out)
        deadline = time.monotonic() + timeout_s
        failed = None
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad and failed is None:
                failed = bad[0]
                # give the others a moment to report their own errors
                deadline = min(deadline, time.monotonic() + 5.0)
            if all(c is not None for c in codes):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        alive = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        results, errors = [], []
        for rank, out in enumerate(outs):
            if os.path.exists(out):
                with open(out, "rb") as f:
                    status, value = pickle.load(f)
                if status == "ok":
                    results.append(value)
                    continue
                errors.append((rank, value))
            results.append(None)
        # A rank that died without a result is the cause; its peers'
        # errors (a reset connection) are the consequence.
        dead = [r for r, (p, o) in enumerate(zip(procs, outs))
                if r not in alive and p.returncode and not os.path.exists(o)]
        if dead:
            rank = dead[0]
            raise RuntimeError(
                f"rank {rank} of {n} died (exit {procs[rank].returncode}) "
                f"without a result:\n{_tail(logs[rank])}")
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(
                f"rank {rank} of {n} failed:\n{tb}\n-- rank {rank} output "
                f"--\n{_tail(logs[rank])}")
        if alive or any(r is None for r in results):
            stuck = alive or [results.index(None)]
            raise TimeoutError(
                f"world of {n} killed after {timeout_s:g} s; ranks {stuck} "
                f"had not finished.  Rank {stuck[0]} output:\n"
                f"{_tail(logs[stuck[0]])}")
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for path in os.listdir(work):
            os.remove(os.path.join(work, path))
        os.rmdir(work)
