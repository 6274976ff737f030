"""Entry points: the flagship generator's forward, ready to call, and the
multi-process dry run (counterparts of ``__graft_entry__.entry`` and
``__graft_entry__.dryrun_multichip`` of the JAX package).

    from video_filler_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry("cuda")
    out = fn(*args)          # (8, 128, 128, 12)
    dryrun_multichip(4)      # 4 gloo processes on the CPU
"""

from __future__ import annotations

import math

import torch

from video_filler_tpu_torch.config import Opt, resolve_device
from video_filler_tpu_torch.models import build_generator, specs_for_regime


def entry(device: str = "cuda"):
    """(fn, example_args): the 128-out video-inpainting generator
    (train_vid_weighted regime, predLen=4 channel-folded clips, nBottleneck
    4000, bf16 compute) in eval mode with its weights frozen, and a batch of
    8 clips, on ``device``; weights from a fixed seed."""
    opt = Opt(predLen=4, nBottleneck=4000, batchSize=8, device=device)
    dev = resolve_device(opt)
    gspec, _ = specs_for_regime(opt, "video")
    gen = build_generator(gspec, torch.Generator().manual_seed(0))
    gen = gen.to(dev).eval().requires_grad_(False)
    x = torch.zeros((opt.batchSize, 128, 128, opt.nc_total),
                    dtype=torch.float32, device=dev)
    return gen, (x,)


def _finite(tag: str, metrics: dict) -> str:
    vals = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in vals.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite {tag} metrics {bad}")
    return ", ".join(f"{k}={v:.4f}" for k, v in vals.items())


def _rows(batch: dict, n: int, i: int, n_micro: int) -> dict:
    from video_filler_tpu_torch.parallel.distributed import data_rows
    rows = data_rows(next(iter(batch.values())).shape[0], n, i, n_micro)
    return {k: v[rows] for k, v in batch.items()}


def _dryrun_rank(n_devices: int) -> list[str]:
    """One rank of ``dryrun_multichip``: the steps on tiny shapes, each on
    its rows of one global batch made from a fixed seed; the report lines
    (rank 0's are printed)."""
    import numpy as np

    from video_filler_tpu_torch.models import build_generator
    from video_filler_tpu_torch.parallel import mesh as mesh_mod
    from video_filler_tpu_torch.parallel.temporal import (
        make_seq_mesh,
        shard_sp_batch,
    )
    from video_filler_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
    )

    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_model
    mesh = mesh_mod.make_mesh(n_data, n_model)
    where = mesh_mod.coords(mesh)
    tag = f"mesh=data:{n_data}xmodel:{n_model}"
    rs = np.random.RandomState(0)
    tiny = dict(nef=8, ngf=8, ndf=8, nBottleneck=64, wtl2=0.999,
                computeDtype="float32", device="cpu")
    lines = []

    def run(name, opt, regime, batch, init_net=None):
        state = init_train_state(opt, regime, torch.Generator().manual_seed(0),
                                 mesh)
        step = make_train_step(opt, regime, with_init=init_net is not None,
                               mesh=mesh)
        local = _rows({k: torch.from_numpy(v) for k, v in batch.items()},
                      where.n_data, where.data_rank, opt.gradAccum)
        m = step(state, local, init_net,
                 **({"gen": torch.Generator().manual_seed(3)}
                    if opt.noiseGen else {}))
        assert state.step == 1
        lines.append(f"dryrun {name} ok: {tag} metrics={{{_finite(name, m)}}}")

    def clips(b, c):
        return rs.rand(b, 128, 128, c).astype(np.float32) * 2 - 1

    def hole(b, c=1):
        m = np.zeros((b, 128, 128, c), np.float32)
        m[:, 40:80, 40:80] = 1.0
        return m

    # gradAccum=2: the microbatches under the sharded mesh, gradients
    # summed once after them
    opt = Opt(predLen=2, batchSize=4 * n_data, weight_nomask=0.05, wtgdl=0.1,
              gradAccum=2, **tiny)
    video = {"real": clips(opt.batchSize, opt.nc_total),
             "mask": hole(opt.batchSize)}
    run("video", opt, "video", video)
    lines[-1] = lines[-1].replace("dryrun video ok", "dryrun_multichip ok")
    init_net = build_generator(specs_for_regime(opt, "video")[0],
                               torch.Generator().manual_seed(7)).eval()
    run("withInit", opt.replace(gradAccum=1), "video", video,
        init_net=init_net)
    b2 = 2 * n_data
    center = {"real": clips(b2, 3)}
    run("conditionAdv", Opt(batchSize=b2, overlapPred=4, conditionAdv=True,
                            **tiny), "center", center)
    run("noiseGen", Opt(batchSize=b2, overlapPred=4, noiseGen=True, **tiny),
        "center", center)
    wi = Opt(batchSize=b2, weight_nomask=0.05, **tiny)
    spec = specs_for_regime(wi, "wholeim")[0]
    run("wholeim", wi, "wholeim", {"masked": clips(b2, spec.nc_in),
                                   "real": clips(b2, spec.nc_out),
                                   "mask": hole(b2, spec.nc_out)})
    if n_devices >= 4 and n_devices % 2 == 0:
        # SP: the video3d step with T sharded over 'seq' (halo convs, the
        # T-gathered bottleneck split over seq, BN over data x seq)
        sp = make_seq_mesh(n_devices // 2, 2)
        spw = mesh_mod.coords(sp)
        opt3 = Opt(predLen=4, batchSize=2 * spw.n_data, weight_nomask=0.05,
                   video3dLevels=4, fineSize=64, **tiny)
        real = rs.rand(opt3.batchSize, 4, 64, 64, 3).astype(np.float32)
        m3 = np.zeros((opt3.batchSize, 1, 64, 64, 1), np.float32)
        m3[:, :, 20:40, 20:40] = 1.0
        state = init_train_state(opt3, "video3d",
                                 torch.Generator().manual_seed(0), sp)
        step = make_train_step(opt3, "video3d", mesh=sp)
        local = shard_sp_batch(spw, {"real": torch.from_numpy(real * 2 - 1),
                                     "mask": torch.from_numpy(m3)})
        m = step(state, local)
        lines.append(f"dryrun SP ok: mesh=data:{spw.n_data}xseq:2 video3d "
                     f"train step metrics={{{_finite('SP', m)}}}")
    return lines


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> None:
    """One step of each train-step variant over an ``n_devices``-process
    mesh on the CPU (gloo), tiny shapes: DP over 'data', with TP on
    'model' when n_devices is even and at least 4; the video step at
    gradAccum 2, withInit, conditionAdv, noiseGen, wholeim, then the
    sequence-parallel video3d step.  Prints the JAX dry run's
    ``dryrun ... ok`` lines; raises if a rank fails or a metric is not
    finite."""
    from video_filler_tpu_torch.parallel.launch import run_world

    lines = run_world(int(n_devices), _dryrun_rank, (int(n_devices),),
                      backend="gloo", device="cpu", timeout_s=timeout_s)[0]
    for line in lines:
        print(line, flush=True)
