"""Device mesh and sharding rules (counterpart of
video_filler_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed`` ``DeviceMesh`` of one process per card
with axes ``('data', 'model')`` (or ``('data', 'seq')`` for the
sequence-parallel video3d step, parallel/temporal.py):

* **DP**: each data rank trains on its rows of the global batch; BatchNorm
  statistics are global (ops/layers.py ``batch_norm`` over a process
  group); gradients are summed over the ranks after the backward
  (train/step.py).
* **TP** (model axis > 1): the two bottleneck "matmuls" shard their
  nBottleneck dimension.  ``enc.conv5`` is column-parallel (each model rank
  computes nB/n output channels), ``bott_bn`` is local to those channels,
  ``dec.up0`` is row-parallel (its partial sums are all-reduced over
  ``model``).  Everything else is replicated.

Unlike XLA's SPMD mesh, every axis spans processes, so the mesh must cover
the world: ``n_data * n_model == world size``; an idle rank would block
every collective.

The sharded tensors follow JAX ``_param_spec``'s rules in the port's
layouts, where all three shard their first axis: ``enc.conv5.weight``
(cout, cin, 4, 4) and its bias, ``bott_bn``'s weight, bias and running
statistics, and ``dec.up0.weight`` (cin, cout, 4, 4); the 3-D family's
(cout, cin, T, 4, 4) weights shard the same axis, with the bottleneck conv
named ``enc.conv{video3dLevels}``.  A rule that matches nothing raises.
noiseGen widens ``bott_bn`` and ``dec.up0`` to nB+nz: the nB channels
split evenly and the last model rank also holds the nz noise channels, so
the shards concatenated in rank order are the full, unsharded layout that
checkpoints keep.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.distributed as dist
from torch import nn

from video_filler_tpu_torch.parallel import comm
from video_filler_tpu_torch.parallel.distributed import (
    data_axis_size,
    gather_pytree,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def mesh_shape(n_data: int | None, n_model: int, world: int,
               axis: str = MODEL_AXIS) -> tuple[int, int]:
    """(n_data, n_model) for a world of ``world`` processes; n_data None or
    0 means ``world // n_model``.  Bad shapes raise ValueError (the JAX
    package's words, with the world size where it counts devices).
    ``axis``: the second axis's name, for the messages."""
    if n_model < 1:
        raise ValueError(f"n_{axis} must be >= 1, got {n_model}")
    if not n_data:
        n_data = world // n_model
        if n_data < 1:
            raise ValueError(
                f"{axis} axis {n_model} does not fit: the world size is "
                f"{world}")
    if n_data * n_model != world:
        raise ValueError(
            f"mesh data:{n_data} x {axis}:{n_model} needs "
            f"{n_data * n_model} processes but the world size is {world}: "
            "every process must hold one point of the mesh (an idle rank "
            "would block every collective)")
    return n_data, n_model


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _build(shape: tuple[int, int], names: tuple[str, str]):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "parallel.distributed.initialize() first")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """A ('data','model') DeviceMesh over the world.  Default: every
    process on the data axis."""
    shape = mesh_shape(n_data, n_model, dist.get_world_size()
                       if dist.is_initialized() else 1)
    return _build(shape, (DATA_AXIS, MODEL_AXIS))


@dataclasses.dataclass(frozen=True)
class Coords:
    """This rank's place in a mesh: the data axis, and the second axis
    (``model`` or ``seq``), each as (size, rank)."""
    n_data: int
    data_rank: int
    shard_axis: str
    n_shard: int
    shard_rank: int

    @property
    def world(self) -> int:
        return self.n_data * self.n_shard


def coords(mesh) -> Coords:
    second = mesh.mesh_dim_names[1]
    return Coords(data_axis_size(mesh), mesh.get_local_rank(DATA_AXIS),
                  second, mesh.size(1), mesh.get_local_rank(second))


def is_sharded(mesh) -> bool:
    """Whether the generator's bottleneck is sharded on this mesh: over
    ``model`` when it has more than one rank, always over ``seq``."""
    c = coords(mesh)
    return c.shard_axis == SEQ_AXIS or c.n_shard > 1


def bottleneck_conv(gen: nn.Module) -> str:
    """The name of the generator's T/spatial-collapsing bottleneck conv:
    ``enc.conv5`` (2-D), ``enc.conv{levels}`` (3-D)."""
    spec = getattr(gen, "spec", None)
    levels = getattr(spec, "levels", None)
    return f"enc.conv{levels}" if levels is not None else "enc.conv5"


def sharding_rules(names, conv: str = "enc.conv5") -> dict[str, str]:
    """The sharded tensors among ``names`` (a generator's parameter and
    buffer names), each with the rule that matched it.  A rule that
    matches no name raises ValueError: a rename must fail loudly rather
    than train partly replicated on a sharded mesh."""
    rules = {
        conv: lambda n: n in (f"{conv}.weight", f"{conv}.bias"),
        "bott_bn": lambda n: n.startswith("bott_bn."),
        "dec.up0.weight": lambda n: n == "dec.up0.weight",
    }
    out = {}
    for name in names:
        for rule, match in rules.items():
            if match(name):
                out[name] = rule
    missing = [r for r in rules if r not in out.values()]
    if missing:
        raise ValueError(
            "TP requested (model axis > 1) but these bottleneck sharding "
            f"rules matched no parameter: {missing} -- have layer names "
            "changed? (see parallel/mesh.py sharding_rules)")
    return out


def _sharded_names(gen: nn.Module) -> list[str]:
    named = [n for n, _ in gen.named_parameters()] + \
        [n for n, _ in gen.named_buffers()]
    return sorted(sharding_rules(named, bottleneck_conv(gen)))


def shard_rows(full: int, nb: int, n: int, r: int) -> tuple[int, int]:
    """[start, stop) of shard ``r`` of ``n`` along a bottleneck axis of
    ``full`` channels, nb of them the encoder's: nb/n each, the last shard
    also taking channels nb..full (noiseGen's nz)."""
    if nb % n:
        raise ValueError(f"nBottleneck {nb} must divide by the {n} shards "
                         "of the bottleneck")
    per = nb // n
    return r * per, (full if r == n - 1 else (r + 1) * per)


def _tensors(state, names) -> dict[str, torch.Tensor]:
    """G's tensors ``names`` and, for a parameter, its Adam moments (keyed
    ``name:exp_avg``, ``name:exp_avg_sq``), flat."""
    params = dict(state.gen.named_parameters())
    buffers = dict(state.gen.named_buffers())
    out = {}
    for name in names:
        if name in buffers:
            out[name] = buffers[name]
            continue
        out[name] = params[name].detach()
        for k, v in state.opt_g.state.get(params[name], {}).items():
            if torch.is_tensor(v) and v.dim():
                out[f"{name}:{k}"] = v
    return out


def _put(state, values: dict[str, torch.Tensor], sharded: bool) -> None:
    """Replace G's tensors by ``values`` (as ``_tensors`` keys them): a
    parameter becomes a new one (flagged ``vf_sharded`` when ``sharded``),
    which G's optimizer and its moments follow."""
    for name in (k for k in values if ":" not in k):
        owner_name, _, attr = name.rpartition(".")
        owner = state.gen.get_submodule(owner_name)
        if attr in owner._buffers:
            owner._buffers[attr] = values[name]
            continue
        old = owner._parameters[attr]
        new = nn.Parameter(values[name], requires_grad=old.requires_grad)
        if sharded:
            new.vf_sharded = True
        owner._parameters[attr] = new
        for group in state.opt_g.param_groups:
            group["params"] = [new if p is old else p
                               for p in group["params"]]
        if old in state.opt_g.state:
            st = state.opt_g.state.pop(old)
            state.opt_g.state[new] = {k: values.get(f"{name}:{k}", v)
                                      for k, v in st.items()}


def shard_state(state, mesh):
    """A full TrainState cut to this rank's shard in place: the generator's
    bottleneck parameters, BN statistics and both Adam moments (f32 or
    ``AdamBf16Moments``'s bf16); its parameters there are flagged
    ``vf_sharded``.  D is replicated.  A no-op when the mesh does not
    shard.  Returns ``state``."""
    if not is_sharded(mesh):
        return state
    c = coords(mesh)
    nb = int(state.gen.spec.n_bottleneck)

    def cut(t):
        lo, hi = shard_rows(t.shape[0], nb, c.n_shard, c.shard_rank)
        return t[lo:hi].clone()
    full = _tensors(state, _sharded_names(state.gen))
    _put(state, {k: cut(v) for k, v in full.items()}, sharded=True)
    return state


def unshard_state(state, mesh):
    """The inverse of ``shard_state``, in place: every rank of the shard
    axis all-gathers the full bottleneck tensors (collectives: call on
    every rank)."""
    if not is_sharded(mesh):
        return state
    group = mesh.get_group(coords(mesh).shard_axis)
    _put(state, gather_pytree(_tensors(state, _sharded_names(state.gen)),
                              group), sharded=False)
    return state


@contextlib.contextmanager
def unsharded(state, mesh):
    """Within the block ``state`` holds the full tensors (to save or
    restore a checkpoint in the single-device layout); sharded again
    after it."""
    unshard_state(state, mesh)
    try:
        yield state
    finally:
        shard_state(state, mesh)


def parallelize(gen: nn.Module, disc: nn.Module, mesh) -> None:
    """Attach the mesh's collectives to freshly built networks (before
    ``shard_state``): every BatchNorm's statistics group -- the whole mesh,
    where the model ranks of a data group hold the same rows (each counted
    once: ``replicas``) and the seq ranks their own frames; ``bott_bn``'s
    the data axis alone under a sharded bottleneck -- and, where the
    bottleneck is sharded, the row-parallel ``up0`` reduction, the SP T
    gathers and the rank that joins noiseGen's z."""
    from video_filler_tpu_torch.ops.layers import BatchNorm

    c = coords(mesh)
    data = mesh.get_group(DATA_AXIS)
    seq = c.shard_axis == SEQ_AXIS
    for m in (*gen.modules(), *disc.modules()):
        if isinstance(m, BatchNorm):
            m.group = dist.group.WORLD
            m.replicas = 1 if seq else c.n_shard
    if not is_sharded(mesh):
        return
    shard = mesh.get_group(c.shard_axis)
    gen.bott_bn.group, gen.bott_bn.replicas = data, 1
    conv = gen.get_submodule(bottleneck_conv(gen))
    up0 = gen.get_submodule("dec.up0")
    if seq:
        # clips are (B,C,T,H,W) inside the 3-D nets: T is dim 2
        conv.pre = functools.partial(comm.all_gather_dim, group=shard, dim=2)
        up0.post = functools.partial(comm.reduce_scatter_dim, group=shard,
                                     dim=2)
        head = disc.get_submodule(f"conv{disc.spec.levels}")
        head.pre = functools.partial(comm.all_gather_dim, group=shard, dim=2)
    else:
        up0.post = functools.partial(comm.all_reduce_sum, group=shard)
    if getattr(gen, "noise_gen", False):
        gen.noise_here = c.shard_rank == c.n_shard - 1
