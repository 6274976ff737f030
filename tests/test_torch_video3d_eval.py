"""video3d inference and the trainer's CLI in the port against the JAX
package: ``run_test_vid``, ``evaluate``, ``bench_inference`` and the
server's device function on one JAX checkpoint (G's weights scaled by 2
and its BN running statistics drawn away from their init, as
tests/test_torch_eval.py makes them), then train / resume / withInit /
keepBest through ``train.loop.main`` and its refusals.

Tolerances (tests/test_torch_eval.py): eval outputs rtol 1e-5 / atol 1e-6,
the inputs the evals build exactly, metrics rtol 1e-5 (each std within
1e-5 of its mean), uint8 within one level and equal outside the mask.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import jax_draws
from video_filler_tpu.checkpoint import ckpt as jckpt
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.eval import metrics as jmetrics
from video_filler_tpu.eval.video import run_test_vid as jrun_test_vid
from video_filler_tpu.serve import InpaintServer as JaxServer
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.eval import common, metrics
from video_filler_tpu_torch.eval.video import run_test_vid
from video_filler_tpu_torch.serve import InpaintServer
from video_filler_tpu_torch.train import loop

torch.set_num_threads(1)

TINY = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, batchSize=2, fineSize=32,
            video3dLevels=3, predLen=2, wtl2=0.999, computeDtype="float32",
            manualSeed=222)
FWD = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _python_decode(monkeypatch):
    """The JAX samplers' Python decode path, which the port's copies."""
    monkeypatch.setenv("VF_NO_NATIVE", "1")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A synthetic corpus and mask, and a JAX video3d checkpoint."""
    d = tmp_path_factory.mktemp("video3d_eval")
    root = synthetic.make_video_corpus(str(d / "corpus"), n_videos=2,
                                       frames=6, h=60, w=80)
    mask = synthetic.make_mask_png(str(d / "mask.png"), h=60, w=80,
                                   box=(5, 8, 30, 40))
    jopt = JaxOpt(**TINY)
    st = jax.jit(lambda k: jstep.init_train_state(k, jopt, "video3d"))(
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(50)

    def params(path, leaf):
        return leaf * 2.0 if path[-1].key == "w" else leaf

    def stats(path, leaf):
        if path[-1].key == "mean":
            return jnp.asarray(rs.normal(0.0, 0.3, leaf.shape), jnp.float32)
        return jnp.asarray(rs.uniform(0.5, 2.0, leaf.shape), jnp.float32)

    st = st._replace(
        params_g=jax.tree_util.tree_map_with_path(params, st.params_g),
        state_g=jax.tree_util.tree_map_with_path(stats, st.state_g))
    net = jckpt.save_checkpoint(str(d), "v3", 1, st)
    data = dict(DATA_ROOT=root, maskName=mask, loadSize=40, net=net)
    return d, data


def _opts(**kw):
    kw = {**TINY, **kw}
    return JaxOpt(**kw), Opt(device="cpu", **kw)


def test_run_test_vid_matches_jax(work, tmp_path):
    _, data = work
    jopt, popt = _opts(**data)
    ref = jrun_test_vid(jopt, out_dir=str(tmp_path / "j"), regime="video3d")
    got = run_test_vid(popt, out_dir=str(tmp_path / "p"), regime="video3d",
                       draws=jax_draws("video", jax.random.PRNGKey(222), 2,
                                       fs=32))
    assert got["fake"].shape == (4, 32, 32, 3)  # batch 2 x predLen 2 frames
    assert os.path.exists(tmp_path / "p" / "pred_4.png")
    assert os.path.exists(str(tmp_path / "p") + "_inpaint.gif")
    np.testing.assert_array_equal(got["ctx"], ref["ctx"])
    for k in ("fake", "inpainted"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k], np.float32),
                                   **FWD, err_msg=k)


def test_evaluate_matches_jax(work):
    _, data = work
    jopt, popt = _opts(**data)
    ref = jmetrics.evaluate(jopt, "video3d", n_batches=2, seed=5)
    key, draws = jax.random.PRNGKey(5), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(jax_draws("video", sub, 2, fs=32))
    got = metrics.evaluate(popt, "video3d", n_batches=2, seed=5, draws=draws)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("_std"):
            mean = abs(ref[k[:-4]])
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5 * mean,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_bench_inference_times_clips_at_the_levels_side(work):
    _, data = work
    _, popt = _opts(**data)
    gen = common.load_generator(popt, "video3d", data["net"], "cpu")
    seen = []
    gen.register_forward_pre_hook(lambda m, args: seen.append(
        tuple(args[0].shape)))
    s = metrics.bench_inference(popt, "video3d", iters=1, loaded=gen)
    assert seen == [(2, 2, 32, 32, 3)] * 2          # warm-up, then 1 timed
    assert s["frames_per_sec"] == pytest.approx(2 * s["clips_per_sec"])


def test_serve_function_matches_the_jax_server(work):
    """Channel-folded uint8 clips (B,S,S,nc*predLen) in and out, the 3-D G
    between, its prediction composited inside the mask."""
    _, data = work
    jopt, popt = _opts(fineSize=128)   # the server reads the levels' side
    rs = np.random.RandomState(5)
    ctx = rs.randint(0, 256, (2, 32, 32, 6), np.uint8)
    mask = np.zeros((2, 32, 32, 1), np.uint8)
    mask[:, 8:20, 6:26] = 255
    jsrv = JaxServer(jopt, "video3d", data["net"], device_thread=False)
    try:
        ref = np.asarray(jsrv._serve_fn(
            jsrv._params, jsrv._bn, ctx, mask,
            np.zeros((2, 1, 1, jopt.nz), np.float32), *jsrv._extra_args))
    finally:
        jsrv.close()
    psrv = InpaintServer(popt, "video3d", data["net"], device_thread=False)
    try:
        assert (psrv.in_h, psrv.in_w, psrv.in_c) == (32, 32, 6)
        got = psrv._serve_fn(ctx, mask)
    finally:
        psrv.close()
    assert got.dtype == np.uint8 and got.shape == ref.shape == ctx.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    outside = np.broadcast_to(mask == 0, ctx.shape)
    np.testing.assert_array_equal(got[outside], ctx[outside])
    assert not np.array_equal(got[~outside], ctx[~outside])


# --- the trainer CLI --------------------------------------------------------

def _args(data, *extra):
    return ["regime=video3d", "device=cpu", "batchSize=2", "nef=8", "ngf=8",
            "ndf=8", "nBottleneck=32", "fineSize=32", "video3dLevels=3",
            "predLen=2", "wtl2=0.999", "weight_nomask=0.05",
            "computeDtype=float32", "ntrain=4", "nThreads=1", "manualSeed=3",
            f"DATA_ROOT={data['DATA_ROOT']}", f"maskName={data['maskName']}",
            "loadSize=40", *extra]


def _steps(path):
    with open(path) as f:
        return [json.loads(line) for line in f if '"step"' in line]


def test_cli_trains_evaluates_resumes_and_cascades(work, tmp_path,
                                                   monkeypatch):
    _, data = work
    monkeypatch.chdir(tmp_path)
    state = loop.main(_args(data, "niter=1", "checkpointEvery=1", "name=v3",
                            "display_iter=1", "evalEvery=1",
                            "evalBatches=1", "keepBest=1"))
    assert state.step == 2
    for f in ("checkpoints/v3_1_state.npz", "checkpoints/v3_best_state.npz",
              "display/v3_e1_s2_inpaint.png"):
        assert os.path.exists(f), f
    state = loop.main(_args(data, "niter=2", "checkpointEvery=1", "name=v3",
                            "display=0", "autoResume=1"))
    assert state.step == 4
    steps = _steps("logs/v3.jsonl")
    assert [r["epoch"] for r in steps] == [1, 1, 2, 2]
    state = loop.main(_args(data, "niter=1", "checkpointEvery=5",
                            "name=cascade", "display_iter=1", "withInit=1",
                            "initName=checkpoints/v3_1_state.npz",
                            "weight_nomask=0"))
    assert state.step == 2
    for r in steps + _steps("logs/cascade.jsonl"):
        for k in ("errD", "errG", "errG_l2", "errG_total"):
            assert np.isfinite(r[k]), (k, r)


@pytest.mark.parametrize("arg,match", [
    ("seqParallel=2", "seq axis 2 does not fit: the world size is 1"),
    ("fineSize=64", "fineSize = 4\\*2\\*\\*video3dLevels = 32"),
    ("noiseGen=1", "video3d has neither"),
], ids=["seqParallel", "fineSize", "noiseGen"])
def test_cli_refuses_by_name(work, tmp_path, monkeypatch, arg, match):
    _, data = work
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=match):
        loop.main(_args(data, "niter=1", arg))
    assert not os.path.exists("logs")


def test_use_bias_checkpoint_runs_test_vid_as_jax(work, tmp_path):
    """useBias on video3d through the eval CLI: a JAX checkpoint whose every
    conv has a nonzero bias (N(0, 0.02), the weights' scale), restored by
    the port's loader (``b`` to each conv's ``bias``, cast to the compute
    dtype), gives JAX's prediction."""
    _, data = work
    jopt, popt = _opts(**{**data, "useBias": True})
    st = jax.jit(lambda k: jstep.init_train_state(k, jopt, "video3d"))(
        jax.random.PRNGKey(1))
    rs = np.random.RandomState(8)
    st = st._replace(params_g=jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rs.normal(0, 0.02, x.shape), jnp.float32)
        if p[-1].key == "b" else x, st.params_g))
    net = jckpt.save_checkpoint(str(tmp_path), "ub", 1, st)
    jopt, popt = jopt.replace(net=net), popt.replace(net=net)
    gen = common.load_generator(popt, "video3d", net, "cpu")
    assert gen.dec.up3.bias.abs().max() > 0
    ref = jrun_test_vid(jopt, out_dir=str(tmp_path / "j"), regime="video3d")
    got = run_test_vid(popt, out_dir=str(tmp_path / "p"), regime="video3d",
                       draws=jax_draws("video", jax.random.PRNGKey(222), 2,
                                       fs=32))
    for k in ("fake", "inpainted"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k], np.float32),
                                   **FWD, err_msg=k)
