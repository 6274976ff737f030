"""What the gradient checks of the sharded train step read, on the CPU.

    python tests/gradient_readings.py COPY_ROOT

First the spread of two right f32 steps on the center batch of
tests/test_torch_parallel.py: the JAX package's f32 step and the port's
one-process f32 step (with torch's default threads, then with one)
against the port's step in float64 (each net's Adam first moments, the
largest difference over a leaf's largest value).

Then, for COPY_ROOT, a copy of the repository (``git archive`` of a
tree) in which one line of ``video_filler_tpu_torch/train/step.py`` may
have been broken on purpose (the 1/world loss share dropped, a gradient
bucket summed over the wrong group), one line per case of
tests/test_torch_parallel.py, tests/test_torch_temporal_sp.py, the
two-rank loops of tests/test_torch_distributed.py and chip_smoke.py's
phase 8 tiny steps (here on gloo CPU ranks): whether the replicas are
bitwise equal, the largest relative metric difference, the largest
parameter difference after the step, and the gradients' difference over
a leaf's largest value against the JAX step (tests) or the port's
one-process step (chip_smoke.py).  Each world runs under run_world's time
limit; a world that fails prints its first error line.  Not collected by
pytest.
"""

import os
import sys
import tempfile

ROOT = os.path.abspath(sys.argv[1]) if __name__ == "__main__" else None


def _rel(got, ref):
    import numpy as np
    return max(float(np.abs(got[n][k] - b).max()
                     / max(float(np.abs(b).max()), 1e-30))
               for n in ref for k, b in ref[n].items())


def _step_readings(outs, ref):
    import jax
    import numpy as np
    import torch

    from video_filler_tpu_torch.checkpoint import convert
    got = outs[0]
    par = 0.0
    for net, params in (("gen", ref["new"].params_g),
                        ("disc", ref["new"].params_d)):
        tree, _ = convert.state_dict_to_tree(
            {k: torch.from_numpy(v) for k, v in got[net].items()})
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            diff = np.abs(np.asarray(a) - np.asarray(b))
            par = max(par, float(diff.max()))
    return {
        "replicas_equal": all(np.array_equal(got[n][k], o[n][k])
                              for o in outs[1:] for n in ("gen", "disc")
                              for k in got[n]),
        "metric_rel": max(abs(got["metrics"][0][k] - v) / max(abs(v), 1e-5)
                          for k, v in ref["metrics"].items()),
        "param_abs": par,
        "grad_vs_jax": _rel(got["mu"], ref["mu"])}


def _port_mu(ref, float64=False):
    """Both nets' Adam first moments after the port's one-process step from
    ``ref``'s state on its batch; ``float64``: every layer's compute
    dtype, the weights and the batch in float64, and the loss kernel's
    plain formula in float64."""
    import torch

    import _torch_workers as workers
    from video_filler_tpu_torch.config import Opt
    from video_filler_tpu_torch.train import step as tstep
    opt = Opt(device="cpu", **ref["opt"])
    state = tstep.init_train_state(opt, ref["regime"],
                                   torch.Generator().manual_seed(0))
    dtype = torch.float64 if float64 else torch.float32
    for module, sd in ((state.gen, ref["gen"]), (state.disc, ref["disc"])):
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in sd.items()})
        if float64:
            module.double()
            for m in module.modules():
                if isinstance(getattr(m, "dtype", None), torch.dtype):
                    m.dtype = dtype
    plain = tstep.fused_weighted_mse
    if float64:
        tstep.fused_weighted_mse = lambda p, t, w: (
            (p - t).square() * w).sum() / p.numel()
    try:
        tstep.make_train_step(opt, ref["regime"])(
            state, {k: torch.from_numpy(v).to(dtype)
                    for k, v in ref["batch"].items()})
    finally:
        tstep.fused_weighted_mse = plain
    return workers.adam_mu(state)


def _show(label, reading):
    print(f"{label}: " + ", ".join(
        f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
        for k, v in reading.items()), flush=True)


def _run(n, cases):
    """The cases' sharded steps in one world of n; None if it failed."""
    import _torch_workers as workers

    from video_filler_tpu_torch.parallel.launch import run_world
    try:
        return run_world(n, workers.many,
                         ([("sharded_step", (c,)) for c in cases],),
                         device="cpu", timeout_s=300)
    except (RuntimeError, TimeoutError) as e:
        print(f"world of {n} failed: {str(e).splitlines()[0][:160]}",
              flush=True)
        return None


def main() -> None:
    sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    import _torch_workers as workers
    import chip_smoke as cs
    import test_torch_distributed as tdist
    import test_torch_parallel as tpar
    import test_torch_temporal_sp as tsp

    from video_filler_tpu_torch.parallel.launch import run_world
    assert os.path.dirname(tpar.__file__) == os.path.join(ROOT, "tests")

    rs = np.random.RandomState(0)
    center = {"real": rs.rand(8, 128, 128, 3).astype(np.float32) * 2 - 1}
    c_ref = tpar._jax_case("center", tpar.TINY, center)
    f64 = _port_mu(c_ref, float64=True)
    spread = {"jax_f32": _rel(c_ref["mu"], f64),
              f"port_f32_{torch.get_num_threads()}_threads":
                  _rel(_port_mu(c_ref), f64)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    spread["port_f32_1_thread"] = _rel(_port_mu(c_ref), f64)
    torch.set_num_threads(threads)
    _show("center batch, against the port's float64 step", spread)
    rs = np.random.RandomState(1)
    noisy = {"real": rs.rand(8, 128, 128, 3).astype(np.float32) * 2 - 1}
    clip = tsp._clip_batch(4, 3)
    nkw = dict(tpar.TINY, noiseGen=True, nz=5)
    refs = {  # label: (world, JAX reference, its case)
        "DP-2 center": (2, c_ref, (tpar.TINY, center, 2, 1, "model")),
        "TP-2 center noiseGen": (2, tpar._jax_case("center", nkw, noisy,
                                                   seed=4),
                                 (nkw, noisy, 1, 2, "model")),
        "TP-2 center, the other options": (
            2, tpar._jax_case("center", tpar.OPTIONS, center),
            (tpar.OPTIONS, center, 1, 2, "model")),
        "DP-4 center": (4, c_ref, (tpar.TINY, center, 4, 1, "model")),
        "TP data 2 x model 2 center": (4, c_ref,
                                       (tpar.TINY, center, 2, 2, "model")),
        "SP data 2 x seq 2 video3d": (
            4, tsp._jax_case("video3d", tsp.V3D, clip, seed=7),
            (tsp.V3D, clip, 2, 2, "seq")),
    }
    for label, (n, ref, (kw, batch, nd, ns, kind)) in refs.items():
        outs = _run(n, [tpar._case(ref, ref["regime"], kw, batch, nd, ns,
                                   kind)])
        if outs is not None:
            _show(label, _step_readings([o[0] for o in outs], ref))

    # the loop: two ranks against one on 8 identical images, the parameters
    # after 2 steps, the gradients after 1 (and, for the spread, after 2)
    tmp = tempfile.mkdtemp()
    data = tdist._images(os.path.join(tmp, "data"), False)
    runs = run_world(2, workers.many, ([
        ("loop_run", (tdist._args(data, name="mh"), tmp)),
        ("loop_run", (tdist._args(data, niter=1, name="mh1"), tmp)),
    ],), device="cpu", timeout_s=300)
    two = tdist._single(tmp, tdist._args(data, name="mh_single"))
    one = tdist._single(tmp, tdist._args(data, niter=1, name="mh1_single"))
    gen = {k: v.numpy() for k, v in two.gen.state_dict().items()}
    _show("loop DP-2 center", {
        "param_abs_2_steps": float(np.abs(tdist._flat(runs[0][0]["gen"])
                                          - tdist._flat(gen)).max()),
        "grad_vs_port_1_step": _rel(runs[0][1]["mu"], workers.adam_mu(one)),
        "grad_vs_port_2_steps": _rel(runs[0][0]["mu"],
                                     workers.adam_mu(two))})

    # chip_smoke.py phase 8 (b)'s tiny steps, on gloo CPU ranks
    for label, spec in cs.par_specs(np):
        try:
            outs = run_world(2, cs.par_tiny_step,
                             (spec, spec["kind"], "cpu"), device="cpu",
                             timeout_s=300)
        except (RuntimeError, TimeoutError) as e:
            print(f"chip_smoke {label}: world failed: "
                  f"{str(e).splitlines()[0][:160]}", flush=True)
            continue
        ref = cs.par_tiny_step(spec, device="cpu")
        _show(f"chip_smoke {label}", {
            "replicas_equal": all(
                np.array_equal(outs[0][n][k], outs[1][n][k])
                for n in ("gen", "disc") for k in outs[0][n]),
            "param_abs": max(float(np.abs(outs[0][n][k] - ref[n][k]).max())
                             for n in ("gen", "disc") for k in ref[n]
                             if "running_" not in k),
            "grad_vs_port": _rel(outs[0]["mu"], ref["mu"])})


if __name__ == "__main__":
    main()
