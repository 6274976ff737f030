"""The port's inference (video_filler_tpu_torch/eval/, the trainer's
evalEvery/keepBest) against the JAX package's.

Both packages load one checkpoint written by the JAX package, whose G has
BatchNorm running statistics far from their init values (random means,
variances in [0.5, 2]) and conv weights scaled by 2, so that a port which
ran BN in train mode, or read the wrong statistics, fails.  Inputs are made
with numpy from a seed; the JAX side's random decisions are passed to the
port where it draws any (the two RNGs differ).

Tolerances: psnr/ssim rtol 1e-5; generator forwards and the float outputs
of the eval runs rtol 1e-5 / atol 1e-6 (f32 convolutions summed in
another order); tiles, geometry, masks and the inputs the evals build
exactly; uint8 frames within one level; the metric dict rtol 1e-5, and
each across-batch std within 1e-5 of its mean (a spread of two values each
held at rtol 1e-5).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.checkpoint import ckpt as jckpt
from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.eval import common as jcommon
from video_filler_tpu.eval import metrics as jmetrics
from video_filler_tpu.eval import tiling as jtiling
from video_filler_tpu.eval.demo import run_demo as jrun_demo
from video_filler_tpu.eval.stream import run_stream as jrun_stream
from video_filler_tpu.eval.test_patch import run_test as jrun_test
from video_filler_tpu.eval.video import run_test_vid as jrun_test_vid
from video_filler_tpu.eval.wholeim import run_wholeim as jrun_wholeim
from video_filler_tpu.ops import losses as jlosses
from video_filler_tpu.train import step as jstep
from video_filler_tpu_torch.checkpoint import ckpt
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.data.index import VideoCorpus
from video_filler_tpu_torch.eval import common, metrics, tiling
from video_filler_tpu_torch.eval.demo import run_demo
from video_filler_tpu_torch.eval.stream import run_stream
from video_filler_tpu_torch.eval.test_patch import run_test
from video_filler_tpu_torch.eval.video import run_test_vid
from video_filler_tpu_torch.eval.wholeim import run_wholeim
from video_filler_tpu_torch.ops import losses
from video_filler_tpu_torch.train import loop
from video_filler_tpu_torch.train import step as tstep

torch.set_num_threads(1)

TINY = dict(nef=8, ngf=8, ndf=8, nBottleneck=32, computeDtype="float32",
            batchSize=2, manualSeed=222, wtl2=0.999)
REGIME_KW = {"center": dict(overlapPred=4), "video": dict(predLen=2),
             "logo": {}, "wholeim": {}}
FWD = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _python_decode(monkeypatch):
    """The JAX samplers' Python decode path, which the port's copies."""
    monkeypatch.setenv("VF_NO_NATIVE", "1")


def jax_checkpoint(d, name, regime, seed=0, **kw):
    """A JAX train state saved as a checkpoint: G's conv weights scaled by
    2 and its BN running statistics drawn away from their init."""
    jopt = JaxOpt(**{**TINY, **REGIME_KW[regime], **kw})
    st = jstep.init_train_state(jax.random.PRNGKey(seed), jopt, regime)
    rs = np.random.RandomState(seed + 50)

    def params(path, leaf):
        return leaf * 2.0 if path[-1].key == "w" else leaf

    def stats(path, leaf):
        if path[-1].key == "mean":
            return jnp.asarray(rs.normal(0.0, 0.3, leaf.shape), jnp.float32)
        return jnp.asarray(rs.uniform(0.5, 2.0, leaf.shape), jnp.float32)

    st = st._replace(
        params_g=jax.tree_util.tree_map_with_path(params, st.params_g),
        state_g=jax.tree_util.tree_map_with_path(stats, st.state_g))
    return jckpt.save_checkpoint(str(d), name, 1, st)


def opts(regime, **kw):
    """(JAX Opt, port Opt) of one configuration."""
    kw = {**TINY, **REGIME_KW[regime], **kw}
    return JaxOpt(**kw), Opt(device="cpu", **kw)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Data of every regime and a JAX checkpoint of each."""
    d = tmp_path_factory.mktemp("eval")
    synthetic.make_image_folder(str(d / "data"), n=6, h=150, w=170)
    synthetic.make_image_folder(str(d / "demo"), n=3, h=140, w=150)
    synthetic.make_video_corpus(str(d / "corpus"), n_videos=2, frames=8,
                                h=180, w=240)
    synthetic.make_mask_png(str(d / "mask.png"), h=180, w=240)
    masked, gt = synthetic.make_paired_folders(str(d / "pairs"), n=6,
                                               h=140, w=150)
    nets = {r: jax_checkpoint(d, r, r, seed=i)
            for i, r in enumerate(REGIME_KW)}
    nets["init"] = jax_checkpoint(d, "init", "video", seed=7)
    data = {"center": dict(DATA_ROOT=str(d / "data"), loadSize=140),
            "video": dict(DATA_ROOT=str(d / "corpus"), loadSize=150,
                          maskName=str(d / "mask.png")),
            "logo": dict(DATA_ROOT=masked, DATA_ROOT_GT=gt, loadSize=0),
            "wholeim": dict(DATA_ROOT=str(d / "corpus"), loadSize=150,
                            maskName=str(d / "mask.png"))}
    return d, nets, data


def _x(regime, n=2, seed=0):
    c = {"center": 3, "video": 6, "logo": 3, "wholeim": 27}[regime]
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, 128, 128, c)).astype(np.float32)


# --- ops ------------------------------------------------------------------

@pytest.mark.parametrize("shape,equal", [((2, 32, 32, 3), False),
                                         ((3, 24, 40, 6), False),
                                         ((1, 16, 16, 3), True)],
                         ids=["rgb", "folded", "equal"])
def test_psnr_and_ssim_match_jax(shape, equal):
    rs = np.random.RandomState(1)
    a = rs.uniform(-1, 1, shape).astype(np.float32)
    b = a if equal else np.clip(
        a + rs.normal(0, 0.2, shape).astype(np.float32), -1, 1)
    for ours, ref in ((losses.psnr, jlosses.psnr),
                      (losses.ssim, jlosses.ssim)):
        got = ours(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(ref(jnp.asarray(a),
                                                         jnp.asarray(b))),
                                   rtol=1e-5)


# --- loader ---------------------------------------------------------------

@pytest.mark.parametrize("regime", list(REGIME_KW))
def test_load_generator_matches_the_jax_forward(work, regime):
    _, nets, _ = work
    jopt, popt = opts(regime)
    fwd, params, bn = jcommon.load_generator(jopt, regime, nets[regime])
    x = _x(regime)
    ref = np.asarray(fwd(params, bn, jnp.asarray(x)))
    gen = common.load_generator(popt, regime, nets[regime], "cpu")
    assert not gen.training
    assert not any(p.requires_grad for p in gen.parameters())
    with torch.inference_mode():
        got = gen(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **FWD)
    # the fixture's statistics matter: batch statistics give another output
    with torch.no_grad():
        train_mode = gen.train()(torch.from_numpy(x)).numpy()
    assert np.abs(train_mode - ref).max() > 1e-2


def test_load_generator_keeps_conv_weights_in_the_compute_dtype(work):
    _, nets, _ = work
    _, popt = opts("video", computeDtype="bfloat16")
    gen = common.load_generator(popt, "video", nets["video"], "cpu")
    sd = gen.state_dict()
    assert sd["enc.conv0.weight"].dtype == torch.bfloat16
    assert sd["dec.up5.weight"].dtype == torch.bfloat16
    assert sd["enc.bn1.weight"].dtype == torch.float32
    assert sd["enc.bn1.running_var"].dtype == torch.float32
    # the forward casts f32 weights to bf16 anyway: the same numbers
    f32 = common.load_generator(popt, "video", nets["video"], "cpu")
    for m in f32.modules():
        if hasattr(m, "dtype") and hasattr(m, "weight"):
            m.weight.data = m.weight.data.float()
    x = torch.from_numpy(_x("video"))
    with torch.inference_mode():
        assert torch.equal(gen(x), f32(x))


@pytest.mark.parametrize("net,item", [("g.t7", "Torch7 .t7 net is a 2-D")],
                         ids=["t7"])
def test_unported_inference_options_exit_naming_their_item(net, item):
    """A .t7 loads in the 2-D regimes (tests/test_torch_t7.py); the
    temporal 3-D family has no Torch7 form and refuses it by name."""
    _, popt = opts("center")
    v3 = popt.replace(predLen=2, fineSize=32, video3dLevels=3)
    with pytest.raises(SystemExit, match=item):
        common.load_generator(v3, "video3d", net, "cpu")
    with pytest.raises(SystemExit, match="video3d"):
        run_test_vid(popt, regime="center")


def test_noise_gen_generator_loads_and_takes_the_jax_draw(tmp_path):
    """A JAX center noiseGen checkpoint through the port's loader: G takes
    (ctx, z) from ``gen_input``, with the JAX side's z (the eval CLIs'
    PRNGKey(manualSeed) draw) its output is JAX's, and by default z comes
    from a torch.Generator seeded with manualSeed."""
    from video_filler_tpu.eval.common import gen_input as jgen_input
    from video_filler_tpu.eval.common import load_generator as jload
    jopt, popt = opts("center", noiseGen=True, nz=5)
    net = jax_checkpoint(tmp_path, "ng", "center", noiseGen=True, nz=5)
    fwd, params, bn = jload(jopt, "center", net)
    gen = common.load_generator(popt, "center", net, "cpu")
    ctx = _x("center")
    jx = jgen_input(jopt, jnp.asarray(ctx), jax.random.PRNGKey(222))
    x = common.gen_input(popt, torch.from_numpy(ctx),
                         noise=torch.from_numpy(np.array(jx[1])))
    with torch.inference_mode():
        got = gen(x).numpy()
        drawn = common.gen_input(popt, torch.from_numpy(ctx))
        again = common.gen_input(popt, torch.from_numpy(ctx))
    np.testing.assert_allclose(got, np.asarray(fwd(params, bn, jx)), **FWD)
    assert drawn[1].shape == (2, 1, 1, 5)
    assert torch.equal(drawn[1], again[1])


def test_live_generator_scores_the_training_state_in_place(tmp_path):
    popt = Opt(device="cpu", **{**TINY, "predLen": 2,
                                "computeDtype": "bfloat16"})
    state = tstep.init_train_state(popt, "video",
                                   torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, b in state.gen.named_buffers():
            b.copy_(torch.rand(b.shape) + 0.5)
    before = {k: v.clone() for k, v in state.gen.state_dict().items()}
    x = torch.from_numpy(_x("video"))
    state.gen.train()
    with common.live_generator(popt, "video", state) as g:
        assert not g.training and torch.is_inference_mode_enabled()
        live = g(x)
    assert state.gen.training
    for k, v in state.gen.state_dict().items():
        assert v.dtype == torch.float32, k           # no cast of the weights
        assert torch.equal(v, before[k]), k          # no stats update
    path = ckpt.save_checkpoint(str(tmp_path), "live", 1, state)
    loaded = common.load_generator(popt, "video", path, "cpu")
    with torch.inference_mode():
        assert torch.equal(loaded(x), live)


# --- tiling ---------------------------------------------------------------

def test_tiling_matches_jax_exactly(work):
    d, _, data = work
    from video_filler_tpu.data.index import VideoCorpus as JaxCorpus
    jopt, popt = opts("video", loadSize=160)
    mask01 = np.random.RandomState(2).rand(180, 240, 1).astype(np.float32)
    ref = jtiling.frame_geometry(jopt, JaxCorpus(data["video"]["DATA_ROOT"]),
                                 1, mask01)
    got = tiling.frame_geometry(popt, VideoCorpus(data["video"]["DATA_ROOT"]),
                                1, mask01)
    assert got[2] == ref[2] == (160, 213, 256, 256)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    folded = np.random.RandomState(3).rand(256, 512, 5).astype(np.float32)
    tiles = np.stack(tiling.gather_tiles(folded, 128))
    np.testing.assert_array_equal(
        tiles, np.stack(jtiling.gather_tiles(folded, 128)))
    np.testing.assert_array_equal(tiles[0], folded[127::-1, :128])
    np.testing.assert_array_equal(tiles[3], folded[:128, 384:])  # unflipped
    back = tiling.scatter_tiles(tiles, 128, 256, 512)
    np.testing.assert_array_equal(
        back, jtiling.scatter_tiles(tiles, 128, 256, 512))
    np.testing.assert_array_equal(back, folded)


# --- eval runs ------------------------------------------------------------

def test_run_demo_matches_jax(work, tmp_path):
    d, nets, _ = work
    kw = dict(imDir=str(d / "demo" / "images"), batchSize=3,
              net=nets["center"])
    jopt, popt = opts("center", **kw)
    ref = jrun_demo(jopt, out_path=str(tmp_path / "j.png"))
    got = run_demo(popt, out_path=str(tmp_path / "p.png"))
    assert os.path.exists(tmp_path / "p.png")
    np.testing.assert_array_equal(got["ctx"], ref["ctx"])
    for k in ("pred_center", "inpainted"):
        np.testing.assert_allclose(got[k], ref[k], **FWD, err_msg=k)


def test_run_test_matches_jax(work, tmp_path):
    _, nets, data = work
    jopt, popt = opts("center", net=nets["center"], **data["center"])
    ref = jrun_test(jopt, out_prefix=str(tmp_path / "j"))
    got = run_test(popt, out_prefix=str(tmp_path / "p"))
    assert os.path.exists(tmp_path / "p_inpainted.png")
    np.testing.assert_array_equal(got["real"], ref["real"])
    np.testing.assert_array_equal(got["ctx"], ref["ctx"])
    np.testing.assert_allclose(got["inpainted"], ref["inpainted"], **FWD)


def _jax_block_draws(key, b, fs):
    """The draws JAX's random_block_mask makes (ops/masks.py:106-110)."""
    bs = fs // 6
    k_n, k_y, k_x = jax.random.split(key, 3)
    return {"n_blocks": jax.random.randint(k_n, (b,), 2, 11),
            "tly": jax.random.randint(k_y, (b, 10), 2, fs - bs - 2),
            "tlx": jax.random.randint(k_x, (b, 10), 2, fs - bs - 2)}


def jax_draws(regime, key, b, fs=128):
    """The decisions JAX's make_preprocess makes from ``key`` for batches
    the samplers already cropped to fineSize, as the port's draws dict."""
    if regime == "video":
        _, k_blk, k_flip = jax.random.split(key, 3)
        d = {"flip": jax.random.uniform(k_flip, (b,)) < 0.5,
             "blocks": _jax_block_draws(k_blk, b, fs)}
    elif regime == "center":
        d = {"flip": jax.random.uniform(jax.random.split(key)[1], (b,))
             < 0.5}
    elif regime == "logo":
        d = {"flip": jax.random.uniform(key, (b,)) < 0.5}
    else:
        d = {}

    def to_torch(t):
        if isinstance(t, dict):
            return {k: to_torch(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t))
    return to_torch(d)


def test_run_test_vid_matches_jax(work, tmp_path):
    _, nets, data = work
    jopt, popt = opts("video", net=nets["video"], **data["video"])
    ref = jrun_test_vid(jopt, out_dir=str(tmp_path / "j"))
    got = run_test_vid(popt, out_dir=str(tmp_path / "p"),
                       draws=jax_draws("video", jax.random.PRNGKey(222), 2))
    assert got["fake"].shape == (4, 128, 128, 3)
    assert os.path.exists(tmp_path / "p" / "inpaint_4.png")
    assert os.path.exists(str(tmp_path / "p") + "_result.gif")
    np.testing.assert_array_equal(got["ctx"], ref["ctx"])
    for k in ("fake", "inpainted"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k], np.float32),
                                   **FWD, err_msg=k)


@pytest.mark.parametrize("with_init", [False, True],
                         ids=["plain", "initName_cascade"])
def test_run_wholeim_matches_jax(work, tmp_path, with_init):
    _, nets, data = work
    kw = dict(data["video"], net=nets["video"], loadSize=160, predLen=4,
              inputLen=2, initName=nets["init"] if with_init else "")
    jopt, popt = opts("video", **kw)
    ref = jrun_wholeim(jopt, out_dir=str(tmp_path / "j"))
    got = run_wholeim(popt, out_dir=str(tmp_path / "p"))
    for name in ("pred_4.png", "inpaint_crop_1.png", "orig_2.png"):
        assert os.path.exists(tmp_path / "p" / name)
    for k in ("input", "orig", "padmask"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("pred", "inpaint"):
        np.testing.assert_allclose(got[k], ref[k], **FWD, err_msg=k)
    pm = got["padmask"][None] > 0
    assert pm.any()
    np.testing.assert_array_equal(np.where(pm, 0, got["inpaint"]),
                                  np.where(pm, 0, got["input"]))


def test_run_stream_matches_jax(work, tmp_path):
    _, nets, data = work
    jopt, popt = opts("video", **{**data["video"], "loadSize": 160},
                      net=nets["video"])
    kw = dict(video=1, start_frame=2, num_frames=5)
    ref = jrun_stream(jopt, out_dir=str(tmp_path / "j"), **kw)
    got = run_stream(popt, out_dir=str(tmp_path / "p"), **kw)
    assert got["n_frames"] == ref["n_frames"] == 4
    assert got["frames"].dtype == np.uint8
    assert got["frames"].shape == ref["frames"].shape == (4, 256, 256, 3)
    diff = np.abs(got["frames"].astype(int) - ref["frames"].astype(int))
    assert diff.max() <= 1
    assert os.path.exists(tmp_path / "p" / "inpaint_00004.png")
    assert os.path.exists(str(tmp_path / "p") + "_inpaint.gif")


@pytest.mark.parametrize("regime", list(REGIME_KW))
def test_evaluate_matches_jax(work, regime):
    _, nets, data = work
    jopt, popt = opts(regime, net=nets[regime], **data[regime])
    ref = jmetrics.evaluate(jopt, regime, n_batches=2, seed=5)
    key, draws = jax.random.PRNGKey(5), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(jax_draws(regime, sub, 2))
    got = metrics.evaluate(popt, regime, n_batches=2, seed=5, draws=draws)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("_std"):
            # the spread of per-batch values each held at rtol 1e-5
            mean = abs(ref[k[:-4]])
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5 * mean,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_bench_inference_and_report(work, tmp_path):
    _, nets, _ = work
    _, popt = opts("video", net=nets["video"])
    gen = common.load_generator(popt, "video", nets["video"], "cpu")
    s = metrics.bench_inference(popt, "video", iters=2, loaded=gen)
    assert set(s) == {"clips_per_sec", "frames_per_sec", "batch_latency_ms"}
    assert s["frames_per_sec"] == pytest.approx(2 * s["clips_per_sec"])
    assert s["batch_latency_ms"] == pytest.approx(2e3 / s["clips_per_sec"])
    q = dict(l2=0.1, hole_l2=0.2, psnr_db=20.0, ssim=0.5, n_batches=2,
             batchSize=2)
    metrics.write_report(str(tmp_path / "m.md"), "video", q, s)
    text = (tmp_path / "m.md").read_text()
    assert "PSNR | 20.00 dB" in text and "frames/s" in text


# --- the trainer's evalEvery / keepBest ------------------------------------

LOOP = ["regime=video", "device=cpu", "batchSize=2", "nef=8", "ngf=8",
        "ndf=8", "nBottleneck=32", "predLen=2", "wtl2=0.999",
        "computeDtype=float32", "ntrain=4", "nThreads=0", "loadSize=150",
        "display=0", "manualSeed=3", "evalEvery=1", "evalBatches=1",
        "keepBest=1"]


def _loop_args(data):
    return [*LOOP, f"DATA_ROOT={data['video']['DATA_ROOT']}",
            f"maskName={data['video']['maskName']}"]


def test_keep_best_file_reads_back_in_both_packages(work, tmp_path,
                                                    monkeypatch):
    _, _, data = work
    monkeypatch.chdir(tmp_path)
    state = loop.main([*_loop_args(data), "niter=1", "checkpointEvery=5",
                       "name=kb"])
    path = "checkpoints/kb_best_state.npz"
    with np.load(path) as f:
        keys = set(f.files)
        meta = json.loads(str(f["__meta__"]))
    assert ".step" in keys and ".params_g['enc']['conv0']['w']" in keys
    assert ".state_g['enc']['bn1']['mean']" in keys
    assert not any(k.startswith((".params_d", ".opt_")) for k in keys)
    assert meta["epoch"] == 1 and meta["step"] == 2 and \
        meta["split"] == "train" and meta["hole_l2"] > 0
    with open("logs/kb.jsonl") as f:
        evals = [json.loads(line) for line in f if "eval_epoch" in line]
    assert evals[0]["hole_l2"] == pytest.approx(meta["hole_l2"], rel=1e-4)
    assert state.gen.training
    # JAX reads the G-only file and gives the port's forward
    jopt, popt = opts("video")
    fwd, params, bn = jcommon.load_generator(jopt, "video", path)
    x = _x("video", seed=4)
    gen = common.load_generator(popt, "video", path, "cpu")
    with torch.inference_mode():
        got = gen(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fwd(params, bn,
                                                   jnp.asarray(x))), **FWD)
    with torch.inference_mode():
        state.gen.eval()
        assert torch.equal(state.gen(torch.from_numpy(x)),
                           torch.from_numpy(got))


@pytest.mark.parametrize("metric,banked,rewritten", [
    ("hole_l2", 0.0, False), ("psnr_db", -1e9, True)],
    ids=["lower_better_kept", "higher_better_beaten"])
def test_best_so_far_survives_auto_resume(work, tmp_path, monkeypatch,
                                          capsys, metric, banked, rewritten):
    _, _, data = work
    monkeypatch.chdir(tmp_path)
    args = [*_loop_args(data), f"bestMetric={metric}", "name=ar",
            "checkpointEvery=1"]
    loop.main([*args, "niter=1"])
    path = "checkpoints/ar_best_state.npz"
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files if k != "__meta__"}
        meta = json.loads(str(f["__meta__"]))
    meta[metric] = banked           # a better value banked before the resume
    np.savez(path, __meta__=json.dumps(meta), **arrays)
    capsys.readouterr()
    state = loop.main([*args, "niter=2", "autoResume=1"])
    assert state.step == 4
    assert f"resuming best-so-far {metric}=" in capsys.readouterr().out
    after = ckpt.read_meta(path)
    assert (after["epoch"] == 2) is rewritten
    assert (after[metric] == banked) is not rewritten


@pytest.mark.parametrize("extra,match", [
    (["evalEvery=0"], "needs evalEvery"),
    (["bestMetric=fid"], "not an eval metric"),
    (["regime=center", "evalSplit=test", "split=100", "overlapPred=4"],
     "empty dataset portion"),
], ids=["keepBest_alone", "bad_metric", "empty_split"])
def test_eval_preflight_refuses_before_training(work, tmp_path, monkeypatch,
                                               extra, match):
    _, _, data = work
    monkeypatch.chdir(tmp_path)
    args = [*_loop_args(data), "niter=1"]
    if "regime=center" in extra:
        args = [a for a in args if not a.startswith(("regime=", "DATA_ROOT",
                                                     "predLen"))]
        args.append(f"DATA_ROOT={data['center']['DATA_ROOT']}")
    with pytest.raises(SystemExit, match=match):
        loop.main([*args, *extra])
    assert not os.path.exists("logs")
