"""Rank functions of the port's multi-process tests: each runs in one
process of a ``run_world`` world (video_filler_tpu_torch/parallel/
launch.py) on the CPU with gloo, imports torch and the port only, and
returns plain numpy/python results for the parent test to compare with
the JAX package's."""

import os

import numpy as np
import torch


def _np(module) -> dict:
    return {k: v.detach().float().numpy().copy()
            for k, v in module.state_dict().items()}


def _moments(module, optimizer) -> dict:
    """The Adam first moments of ``module``'s parameters (f32 numpy): after
    one step (1 - beta1) times the gradient, so linear in it."""
    return {n: optimizer.state[p]["exp_avg"].detach().float().cpu()
            .numpy().copy() for n, p in module.named_parameters()}


def adam_mu(state) -> dict:
    return {"gen": _moments(state.gen, state.opt_g),
            "disc": _moments(state.disc, state.opt_d)}


def _mesh(kind: str, n_data: int, n_shard: int):
    from video_filler_tpu_torch.parallel import mesh as mesh_mod
    from video_filler_tpu_torch.parallel import temporal
    if kind == "seq":
        return temporal.make_seq_mesh(n_data, n_shard)
    return mesh_mod.make_mesh(n_data, n_shard)


def sharded_step(case: dict) -> dict:
    """One (or ``steps``) train step(s) of the port on this rank's mesh:
    the state loaded from the full state dicts ``gen``/``disc`` (the JAX
    init, converted), this rank's rows (and frames) of the global batch,
    optional global ``noise``.  Returns the metrics, the full G and D
    after the step, their Adam first moments (gathered) and the local
    shapes of the sharded tensors."""
    from video_filler_tpu_torch.config import Opt
    from video_filler_tpu_torch.parallel import mesh as mesh_mod
    from video_filler_tpu_torch.parallel import temporal
    from video_filler_tpu_torch.parallel.distributed import data_rows
    from video_filler_tpu_torch.train import step as tstep

    opt = Opt(device="cpu", **case["opt"])
    regime = case["regime"]
    mesh = _mesh(case.get("kind", "model"), case["n_data"], case["n_shard"])
    where = mesh_mod.coords(mesh)
    state = tstep.init_train_state(opt, regime,
                                   torch.Generator().manual_seed(0), mesh)
    if case.get("gen") is not None:
        with mesh_mod.unsharded(state, mesh):
            state.gen.load_state_dict(
                {k: torch.from_numpy(v) for k, v in case["gen"].items()})
            state.disc.load_state_dict(
                {k: torch.from_numpy(v) for k, v in case["disc"].items()})
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    if where.shard_axis == "seq":
        batch = temporal.shard_sp_batch(where, batch, opt.gradAccum)
    else:
        rows = data_rows(opt.batchSize, where.n_data, where.data_rank,
                         opt.gradAccum)
        batch = {k: v[rows] for k, v in batch.items()}
    kw = {}
    if case.get("noise") is not None:
        kw["noise"] = torch.from_numpy(case["noise"])
    if case.get("init") is not None:
        kw["init_net"] = init_net(opt, regime, case["init"])
    step = tstep.make_train_step(opt, regime, with_init="init_net" in kw,
                                 mesh=mesh)
    metrics = []
    for _ in range(case.get("steps", 1)):
        metrics.append({k: float(v) for k, v in
                        step(state, batch, **kw).items()})
    shapes = {n: tuple(p.shape) for n, p in state.gen.named_parameters()}
    shapes.update({n: tuple(b.shape) for n, b in state.gen.named_buffers()})
    moments = {n: tuple(state.opt_g.state[p]["exp_avg"].shape)
               for n, p in state.gen.named_parameters()
               if p in state.opt_g.state}
    with mesh_mod.unsharded(state, mesh):
        return {"metrics": metrics, "gen": _np(state.gen),
                "disc": _np(state.disc), "mu": adam_mu(state),
                "shapes": shapes,
                "moments": moments, "step": state.step,
                "coords": (where.n_data, where.data_rank, where.n_shard,
                           where.shard_rank)}


def init_net(opt, regime: str, sd: dict):
    """withInit's generator (replicated, unsharded) from a state dict."""
    from video_filler_tpu_torch.models import (
        build_generator,
        specs_for_regime,
    )
    gen = build_generator(specs_for_regime(opt, regime)[0],
                          torch.Generator().manual_seed(0))
    gen.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return gen.eval().requires_grad_(False)


def mesh_facts() -> dict:
    """The default mesh, a 2x2 mesh and a seq mesh over this world: their
    shapes, this rank's coordinates and the data axis size."""
    from video_filler_tpu_torch.parallel import mesh as mesh_mod
    from video_filler_tpu_torch.parallel.distributed import data_axis_size
    from video_filler_tpu_torch.parallel import temporal
    out = {}
    for name, mesh in (("default", mesh_mod.make_mesh()),
                       ("2x2", mesh_mod.make_mesh(n_data=2, n_model=2)),
                       ("0x2", mesh_mod.make_mesh(n_data=0, n_model=2)),
                       ("seq", temporal.make_seq_mesh(2, 2))):
        out[name] = (dict(zip(mesh.mesh_dim_names, mesh.shape)),
                     mesh_mod.coords(mesh), data_axis_size(mesh))
    try:
        mesh_mod.make_mesh(n_data=1, n_model=2)
    except ValueError as e:
        out["idle"] = str(e)
    return out


def many(cases: list) -> list:
    """Several (function name, args) cases in one world, in order."""
    import sys
    mod = sys.modules[__name__]
    return [getattr(mod, name)(*args) for name, args in cases]


def global_bn(x: np.ndarray, w: np.ndarray, b: np.ndarray,
              r: np.ndarray) -> dict:
    """Training-mode BatchNorm of this rank's rows of ``x`` with the
    statistics of the whole world's: the output, d(sum(y*r))/dx of the
    rows, the weight and bias gradients of this rank, and the running
    statistics after the update."""
    import torch.distributed as dist

    from video_filler_tpu_torch.ops.layers import BatchNorm
    n, i = dist.get_world_size(), dist.get_rank()
    per = x.shape[0] // n
    bn = BatchNorm(x.shape[1])
    bn.group = dist.group.WORLD
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xl = torch.from_numpy(x[i * per:(i + 1) * per]).requires_grad_(True)
    y = bn.train()(xl)
    (y * torch.from_numpy(r[i * per:(i + 1) * per])).sum().backward()
    return {"y": y.detach().numpy(), "gx": xl.grad.numpy(),
            "gw": bn.weight.grad.numpy(), "gb": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def sp_convs(x: np.ndarray, w_conv: np.ndarray, w_convt: np.ndarray,
             r: np.ndarray, r_t: np.ndarray) -> dict:
    """SPConv3d and SPConvTranspose3d on this rank's frames of a
    (B,C,T,H,W) clip (a seq mesh over the world): outputs, the input
    gradient of sum(y*r) and this rank's weight gradient, per conv."""
    from video_filler_tpu_torch.parallel import temporal
    mesh = temporal.make_seq_mesh(1, torch.distributed.get_world_size())
    group = mesh.get_group("seq")
    s, n = mesh.get_local_rank("seq"), mesh.size(1)
    per = x.shape[2] // n
    out = {}
    for name, cls, w, rr in (
            ("conv", temporal.SPConv3d, w_conv, r),
            ("convt", temporal.SPConvTranspose3d, w_convt, r_t)):
        cin, cout = x.shape[1], rr.shape[1]
        layer = cls(cin, cout, dtype=torch.float32, group=group)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w))
        xl = torch.from_numpy(
            np.ascontiguousarray(x[:, :, s * per:(s + 1) * per])
        ).requires_grad_(True)
        y = layer(xl)
        (y * torch.from_numpy(np.ascontiguousarray(
            rr[:, :, s * per:(s + 1) * per]))).sum().backward()
        out[name] = {"y": y.detach().numpy(), "gx": xl.grad.numpy(),
                     "gw": layer.weight.grad.numpy()}
    return out


def loop_run(args: list, cwd: str, name_dirs: dict | None = None,
             rank_args: dict | None = None) -> dict:
    """``train.loop.main(args)`` from ``cwd`` (or, with ``name_dirs``, from
    the directory named for this rank), with ``rank_args[rank]`` appended;
    the final step, full G and both nets' Adam first moments, or the
    SystemExit message it ended with."""
    import torch.distributed as dist

    from video_filler_tpu_torch.parallel import mesh as mesh_mod
    from video_filler_tpu_torch.train import loop
    rank = dist.get_rank()
    os.chdir(name_dirs[rank] if name_dirs else cwd)
    try:
        state = loop.main([*args, *(rank_args or {}).get(rank, [])])
    except SystemExit as e:
        return {"exit": str(e)}
    with mesh_mod.unsharded(state, state.mesh):
        return {"step": state.step, "gen": _np(state.gen),
                "mu": adam_mu(state)}


def save_then_loop(args: list, dirs: dict, ckpt_opt: dict) -> dict:
    """Rank 0 alone writes a checkpoint into its directory, then every
    rank runs the loop from its own directory (the resume-desync case)."""
    import torch.distributed as dist

    from video_filler_tpu_torch.checkpoint import save_checkpoint
    from video_filler_tpu_torch.config import Opt
    from video_filler_tpu_torch.train import step as tstep
    rank = dist.get_rank()
    if rank == 0:
        opt = Opt(device="cpu", **ckpt_opt)
        state = tstep.init_train_state(opt, "center",
                                       torch.Generator().manual_seed(0))
        save_checkpoint(os.path.join(dirs[0], "checkpoints"), "ds", 1,
                        state)
    dist.barrier()
    return loop_run(args, "", dirs)


def die_or_hang(mode: str) -> None:
    """Rank 1 dies (``die``) or sleeps (``hang``); rank 0 waits for it in
    an all_reduce."""
    import time

    import torch.distributed as dist
    if dist.get_rank() == 1:
        if mode == "die":
            os._exit(3)
        time.sleep(3600)
    dist.all_reduce(torch.ones(1))
