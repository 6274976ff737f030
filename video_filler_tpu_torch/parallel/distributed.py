"""Multi-process training support (counterpart of
video_filler_tpu/parallel/distributed.py).

One process per card, as ``torchrun`` starts them:

* ``initialize()`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and initialises the
  default process group: NCCL for a CUDA device, gloo for ``device=cpu``
  (or the ``backend`` asked for).  Without that environment it does
  nothing and the run stays one process.  With it, a failed handshake
  raises: N processes must never train independently against one
  checkpoint name.
* a rank's device is ``cuda:{LOCAL_RANK}`` unless the caller names one; it
  never falls back to the CPU.
* each data rank feeds its slice of the global batch
  (``process_batch_slice``); ``gather_pytree`` all-gathers sharded tensors
  (the TP bottleneck for a checkpoint).

The JAX module's ``_guard_cpu_collective_cache`` has no counterpart: it
guards XLA's compile cache.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from video_filler_tpu_torch.parallel import comm

_ENV = ("RANK", "WORLD_SIZE")


def env_present() -> bool:
    """Whether torchrun's (or run_world's) rank environment is set."""
    return all(os.environ.get(k) for k in _ENV)


def rank_device(device: str | None = None) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:{LOCAL_RANK}``."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize(backend: str | None = None, device: str | None = None,
               timeout_s: float | None = None) -> bool:
    """Join the world described by the environment; True when a process
    group exists afterwards.  A no-op without the environment, or when the
    group already exists.

    backend: ``"nccl"`` or ``"gloo"``; default NCCL for a CUDA device,
    gloo for the CPU.  device: this rank's device (``rank_device``), made
    current when it is a CUDA device.  timeout_s: the handshake's and
    every collective's time limit (PyTorch's default when None)."""
    if dist.is_available() and dist.is_initialized():
        return True
    if not env_present():
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank device {dev} but CUDA is not available "
                               "on this machine (pass device=cpu)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), **kw)
    return True


def is_multi() -> bool:
    """Whether a process group exists (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_multi() else 1


def process_index() -> int:
    return dist.get_rank() if is_multi() else 0


def process_batch_slice(global_batch: int, n: int | None = None,
                        index: int | None = None) -> tuple[int, int]:
    """(start, size) of one slice of the global batch: slice ``index`` of
    ``n`` equal ones (default: this process's of the world's)."""
    n = process_count() if n is None else n
    index = process_index() if index is None else index
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide by "
                         f"the {n} data ranks")
    per = global_batch // n
    return index * per, per


def data_rows(global_batch: int, n_data: int, data_rank: int,
              n_micro: int = 1) -> torch.Tensor:
    """The global batch's rows that data rank ``data_rank`` of ``n_data``
    holds, as an index tensor: its equal share of each of the ``n_micro``
    microbatches of gradAccum (microbatch i is global rows [i*m, (i+1)*m)),
    so the sharded step's microbatches are the one-device step's: the
    ``process_batch_slice`` of each microbatch."""
    if global_batch % n_micro:
        raise ValueError(f"global batch {global_batch} must divide by "
                         f"{n_micro} microbatches")
    m = global_batch // n_micro
    start, per = process_batch_slice(m, n_data, data_rank)
    return torch.cat([torch.arange(i * m + start, i * m + start + per)
                      for i in range(n_micro)])


def data_axis_size(mesh) -> int:
    """The number of data ranks of ``mesh`` (its first axis)."""
    return mesh.size(mesh.mesh_dim_names.index("data"))


def gather_pytree(tree: dict[str, torch.Tensor], group,
                  axis: int = 0) -> dict[str, torch.Tensor]:
    """Full values of a dict of tensors sharded over ``group`` along
    ``axis`` (in rank order; the last shard may be wider, as noiseGen's
    bottleneck is): the collective gather behind a TP checkpoint.  Every
    rank of ``group`` must call it with the same names: one all-gather per
    tensor, in sorted name order, in f32 (a bf16 Adam moment is cast back
    after it)."""
    return {name: comm.gather_uneven(tree[name].float(), group,
                                     axis).to(tree[name].dtype)
            for name in sorted(tree)}
