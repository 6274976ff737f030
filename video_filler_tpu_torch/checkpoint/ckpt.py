"""Checkpoint / resume in the JAX package's file format (counterpart of
video_filler_tpu/checkpoint/ckpt.py).

A checkpoint is the whole training state -- G and D parameters, BN running
statistics, both Adam states and the step -- in one ``.npz`` at
``<dir>/<name>_<epoch>_state.npz``.  Its keys are the ``jax.tree_util.keystr``
paths of the JAX package's ``TrainState`` NamedTuple, plus a ``__meta__``
JSON string, so a file written by either package restores in the other:

    .params_g['enc']['conv0']['w']      conv weight, HWIO
    .params_g['dec']['up0']['w']        transposed conv, (k,k,cin,cout)
    .state_g['enc']['bn1']['mean']      BN running statistics
    .opt_g[0].count                     optax ScaleByAdamState (int32)
    .opt_g[0].mu[...], .opt_g[0].nu[...]  first/second moments, param layout
    .step                               int32

optax's Adam state is the tuple ``(ScaleByAdamState(count, mu, nu),
EmptyState())``; ``torch.optim.Adam`` keeps ``step``, ``exp_avg`` and
``exp_avg_sq`` per parameter.  The moments change layout as their
parameters do (checkpoint/convert.py).  Both optimizers add eps after the
bias correction, so a resume continues the same update.

Under ``adamMomentsBf16`` the JAX optimizer state is the dict
``{'count', 'mu', 'nu'}`` (train/step.py ``_adam_lowmem``), so its keys are

    .opt_g['count']                     int32
    .opt_g['mu'][...], .opt_g['nu'][...]  bf16 moments, stored as f32

and the port's ``AdamBf16Moments`` casts them back to bf16 on restore.  A
file of one kind does not resume a run of the other: it raises, naming
both.  The JAX package stores bf16 leaves as f32; so does this one (every
float leaf is f32).

A keepBest file (``<name>_best_state.npz``) holds G only: its parameters,
BN statistics and the step (``flatten_generator``).

On a mesh whose bottleneck is sharded (parallel/mesh.py), a file is still
the single-device layout: every rank gathers the state
(``mesh.unsharded``), rank 0 writes it, and a restore reads the full
state into every rank, which then cuts its shard (the train loop does
both), so a TP run's checkpoint loads in a one-device run and in the JAX
package.

Writes are atomic (tmp + rename).  ``async_write=True`` copies the state to
the host at once -- the step updates the tensors in place right after -- and
writes the file on a background thread; ``wait_pending_saves`` joins the
writers and raises if one failed.
"""

from __future__ import annotations

import json
import os
import re
import threading

import numpy as np
import torch

from video_filler_tpu_torch.checkpoint import convert
from video_filler_tpu_torch.train.optim import AdamBf16Moments


def _key(prefix: str, path: tuple[str, ...]) -> str:
    return prefix + "".join(f"[{p!r}]" for p in path)


def _host(t: torch.Tensor) -> torch.Tensor:
    """An f32 copy on the CPU that the training step cannot change."""
    return t.detach().to("cpu", torch.float32, copy=True)


def _put(out: dict, sd: dict[str, torch.Tensor], prefix: str,
         state_prefix: str | None = None) -> None:
    """Add a state dict's entries to the flat key dict: parameters under
    ``prefix`` in the JAX layout, BN statistics under ``state_prefix``."""
    for name, t in sd.items():
        is_state, path = convert.jax_path(name, t.dim())
        arr = _host(t).numpy()
        if not is_state:
            arr = convert.to_jax_layout(path, arr)
        out[_key(state_prefix if is_state else prefix, path)] = \
            np.ascontiguousarray(arr)


def _take(stored: dict[str, np.ndarray], like: dict[str, torch.Tensor],
          prefix: str, state_prefix: str | None = None
          ) -> dict[str, torch.Tensor]:
    """Inverse of ``_put``: tensors shaped like ``like``'s, read from the
    flat keys.  A missing key or a shape mismatch (wrong config) raises."""
    out = {}
    for name, t in like.items():
        is_state, path = convert.jax_path(name, t.dim())
        key = _key(state_prefix if is_state else prefix, path)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = stored[key]
        # the target's shape in the file's layout (a zero-stride view)
        want = np.broadcast_to(np.bool_(0), tuple(t.shape))
        if not is_state:
            want = convert.to_jax_layout(path, want)
        if arr.shape != want.shape:
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{arr.shape} vs target {want.shape}")
        if not is_state:
            arr = convert.to_torch_layout(path, arr)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr,
                                                          dtype=np.float32))
    return out


def _adam_bases(tag: str, bf16: bool) -> tuple[str, str, str]:
    """The (count, mu, nu) key prefixes of one optimizer's state in the
    file: optax's ScaleByAdamState, or the adamMomentsBf16 dict."""
    if bf16:
        return (f".opt_{tag}['count']", f".opt_{tag}['mu']",
                f".opt_{tag}['nu']")
    base = f".opt_{tag}[0]"
    return f"{base}.count", f"{base}.mu", f"{base}.nu"


def _adam_moments(module: torch.nn.Module, opt: torch.optim.Optimizer):
    """(count, exp_avg by parameter name, exp_avg_sq by name); zeros for an
    optimizer that has not stepped."""
    mu, nu, counts = {}, {}, set()
    for name, p in module.named_parameters():
        st = opt.state.get(p)
        counts.add(int(st["step"]) if st else 0)
        mu[name] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
    if len(counts) != 1:
        raise ValueError(f"parameters of one optimizer at different steps: "
                         f"{sorted(counts)}")
    return counts.pop(), mu, nu


def flatten_state(state) -> dict[str, np.ndarray]:
    """The port's TrainState as the JAX package's flat checkpoint keys,
    copied to the host."""
    flat: dict[str, np.ndarray] = {}
    for tag, module, opt in (("g", state.gen, state.opt_g),
                             ("d", state.disc, state.opt_d)):
        _put(flat, module.state_dict(), f".params_{tag}", f".state_{tag}")
        count, mu, nu = _adam_moments(module, opt)
        k_count, k_mu, k_nu = _adam_bases(tag, isinstance(opt, AdamBf16Moments))
        flat[k_count] = np.asarray(count, np.int32)
        _put(flat, mu, k_mu)
        _put(flat, nu, k_nu)
    flat[".step"] = np.asarray(state.step, np.int32)
    return flat


def flatten_generator(state) -> dict[str, np.ndarray]:
    """G's parameters and BN statistics and the step, copied to the host:
    the keys the JAX package's keepBest payload (``_BestG``) flattens to.
    Inference reads such a file like any checkpoint (``restore_subtree``);
    D and the Adam moments are left out."""
    flat: dict[str, np.ndarray] = {}
    _put(flat, state.gen.state_dict(), ".params_g", ".state_g")
    flat[".step"] = np.asarray(state.step, np.int32)
    return flat


def _load(path: str, prefixes: tuple[str, ...] = ("",)
          ) -> tuple[dict[str, np.ndarray], dict]:
    """(the arrays whose keys start with one of ``prefixes``, meta).  The
    others are not read: a video3d file holds ~3.4 GB, its G ~1.1 GB."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        stored = {k: data[k] for k in data.files
                  if k != "__meta__" and k.startswith(prefixes)}
    return stored, meta


def read_meta(path: str) -> dict:
    """A checkpoint's ``__meta__`` dict, without reading its arrays."""
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"]))


def _load_module(stored, module: torch.nn.Module, prefix: str,
                 state_prefix: str | None) -> None:
    sd = module.state_dict()
    new = _take(stored, sd, prefix, state_prefix)
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_(new[k])


def _load_adam(stored, module: torch.nn.Module, opt: torch.optim.Optimizer,
               tag: str) -> None:
    bf16 = isinstance(opt, AdamBf16Moments)
    k_count, k_mu, k_nu = _adam_bases(tag, bf16)
    if k_count not in stored:
        other = _adam_bases(tag, not bf16)[0]
        if other in stored:
            kinds = ("f32 Adam moments (adamMomentsBf16=0)",
                     "bf16 Adam moments (adamMomentsBf16=1)")
            raise ValueError(
                f"the checkpoint holds {kinds[not bf16]} for opt_{tag}, but "
                f"this run uses {kinds[bf16]}: resume with the setting the "
                "file was written with")
        raise KeyError(f"checkpoint missing leaf {k_count}")
    count = int(stored[k_count])
    params = dict(module.named_parameters())
    mu = _take(stored, params, k_mu)
    nu = _take(stored, params, k_nu)
    opt.state.clear()
    for name, p in params.items():
        if bf16:
            step = torch.tensor(count, dtype=torch.int32, device=p.device)
            dtype = torch.bfloat16
        else:
            step = torch.tensor(float(count), dtype=torch.float32)
            dtype = p.dtype
        opt.state[p] = {"step": step,
                        "exp_avg": mu[name].to(p.device, dtype),
                        "exp_avg_sq": nu[name].to(p.device, dtype)}


def checkpoint_path(ckpt_dir: str, name: str, epoch: int | str) -> str:
    """Non-numeric ``epoch`` tags (e.g. ``"best"``) give files that the
    retention and resume scanners ignore (their ``_(\\d+)_`` patterns)."""
    return os.path.join(ckpt_dir, f"{name}_{epoch}_state.npz")


_PENDING_SAVES: list[threading.Thread] = []
_SAVE_ERRORS: list[tuple[str, BaseException]] = []


def save_checkpoint(ckpt_dir: str, name: str, epoch: int | str, state,
                    meta: dict | None = None, async_write: bool = False,
                    generator_only: bool = False) -> str:
    """Atomic save (tmp + rename) of the whole TrainState, or with
    ``generator_only`` of G, its BN statistics and the step
    (``flatten_generator``); returns the path.

    ``async_write=True``: the device-to-host copy happens here, the
    serialization and disk write on a background thread.  Call
    :func:`wait_pending_saves` before reading the file or exiting."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, name, epoch)
    tmp = path + ".tmp"
    flat = (flatten_generator if generator_only else flatten_state)(state)

    def write() -> None:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta or {}), **flat)
        os.replace(tmp, path)

    if not async_write:
        write()
        return path
    _raise_pending_error()  # an earlier failed write surfaces now

    def guarded() -> None:
        try:
            write()
        except BaseException as e:  # noqa: BLE001 -- reported to the caller
            _SAVE_ERRORS.append((path, e))

    t = threading.Thread(target=guarded, daemon=False)
    t.start()
    _PENDING_SAVES.append(t)
    return path


def _raise_pending_error() -> None:
    errs = []
    while _SAVE_ERRORS:
        errs.append(_SAVE_ERRORS.pop(0))
    if errs:
        paths = ", ".join(f"{p!r} ({type(e).__name__}: {e})" for p, e in errs)
        raise RuntimeError(
            f"async checkpoint write failed -- file(s) NOT saved (disk full "
            f"/ permissions?): {paths}") from errs[0][1]


def wait_pending_saves(timeout: float | None = None) -> None:
    """Block until every async checkpoint write is on disk; raise if one
    failed.  A thread still alive after ``timeout`` stays tracked."""
    still_running = []
    while _PENDING_SAVES:
        t = _PENDING_SAVES.pop()
        t.join(timeout)
        if t.is_alive():
            still_running.append(t)
    _PENDING_SAVES.extend(still_running)
    _raise_pending_error()


def restore_checkpoint(path: str, state) -> dict:
    """Load a checkpoint into ``state`` (the port's TrainState) in place:
    weights, BN statistics, both Adam states and the step.  Returns the
    meta dict.  Every leaf the state needs must be in the file with its
    shape -- a mismatch (wrong config) raises."""
    stored, meta = _load(path)
    for tag, module, opt in (("g", state.gen, state.opt_g),
                             ("d", state.disc, state.opt_d)):
        _load_module(stored, module, f".params_{tag}", f".state_{tag}")
        _load_adam(stored, module, opt, tag)
    state.step = int(stored[".step"])
    return meta


def restore_subtree(path: str, module: torch.nn.Module,
                    prefix: str = ".params_g",
                    state_prefix: str | None = ".state_g") -> torch.nn.Module:
    """Load one network from any checkpoint whose network matches: the
    parameters under ``prefix`` and the BN statistics under
    ``state_prefix`` (the reference's util.load of a single net, as the
    withInit cascade needs it, train_mycrit.lua:261-265).  D and the
    optimizer states in the file need not match.  Returns ``module``."""
    stored, _ = _load(path, tuple(p + "[" for p in (prefix, state_prefix)
                                  if p))
    _load_module(stored, module, prefix, state_prefix)
    return module


def prune_checkpoints(ckpt_dir: str, name: str, keep: int) -> list[str]:
    """Delete ``name``'s checkpoints beyond the newest ``keep`` (by epoch);
    returns the deleted paths.  keep <= 0 keeps all.  Pending async writes
    are joined first, so the count sees every finished file."""
    if keep <= 0 or not os.path.isdir(ckpt_dir):
        return []
    wait_pending_saves()
    pat = re.compile(re.escape(name) + r"_(\d+)_state\.npz$")
    found = sorted(((int(m.group(1)), fn) for fn in os.listdir(ckpt_dir)
                    if (m := pat.match(fn))), reverse=True)
    deleted = []
    for _, fn in found[keep:]:
        p = os.path.join(ckpt_dir, fn)
        os.remove(p)
        deleted.append(p)
    return deleted


def restore_latest(ckpt_dir: str, name: str, state):
    """Resume ``state`` from ``name``'s highest-epoch checkpoint: returns
    (meta, epoch), or None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    pat = re.compile(re.escape(name) + r"_(\d+)_state\.npz$")
    best, best_epoch = None, -1
    for fn in os.listdir(ckpt_dir):
        m = pat.match(fn)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = fn, int(m.group(1))
    if best is None:
        return None
    meta = restore_checkpoint(os.path.join(ckpt_dir, best), state)
    return meta, best_epoch
