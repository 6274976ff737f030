"""Experiment configuration for the PyTorch port.

The port shares the JAX package's option table (``video_filler_tpu.config``,
which imports no jax) and its reference env-var / ``key=value`` semantics.
It adds one field, ``device``: the port never picks a device by itself, and
``device=cuda`` on a machine without CUDA raises.

``from_args`` is the port's own: the JAX one pins the jax platform first,
which would import jax.
"""

from __future__ import annotations

import dataclasses

import torch

from video_filler_tpu.config import REGIMES, _coerce, from_env, split_regime
from video_filler_tpu.config import Opt as _JaxOpt

__all__ = ["Opt", "REGIMES", "from_args", "resolve_device", "split_regime"]


@dataclasses.dataclass
class Opt(_JaxOpt):
    device: str = "cuda"     # torch device the step runs on ("cuda", "cpu")


def resolve_device(opt: Opt) -> torch.device:
    """``opt.device`` as a torch.device; raises if it names CUDA and CUDA is
    not available (no silent fallback to the CPU)."""
    dev = torch.device(opt.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={opt.device!r} but CUDA is not available "
                           "on this machine (pass device=cpu to run on the "
                           "CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {opt.device!r}")
    return dev


def from_args(argv: list[str], base: Opt | None = None) -> Opt:
    """CLI override: ``key=value`` pairs over the env-var shim, with the
    reference's names and coercion."""
    opt = from_env(base or Opt())
    names = {f.name for f in dataclasses.fields(opt)}
    updates = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        if k not in names:
            raise SystemExit(f"unknown option {k!r}")
        try:
            updates[k] = _coerce(v, getattr(opt, k))
        except ValueError as e:
            raise SystemExit(f"bad value for {k}: {e}")
    return opt.replace(**updates) if updates else opt
