"""The port's device-resident data (data/device_data.py, ``dataDevice=1``)
against the JAX package's.

* ``load_corpus``: the same uint8 arrays (byte-equal) and tables as the
  JAX ``load_corpus``, in all five regimes.
* The gathers, given explicit decisions, equal numpy slicing (the replica
  of the JAX sampler's ``lax.dynamic_slice``) on the JAX arrays; the
  wholeim transform equals the JAX sampler's exposed ``transform``.
* The port's sampler keeps the JAX distributions (the cases of
  tests/test_device_data.py on value-coded corpora), including the
  dark-crop rejection's: a sample is its first accepted attempt.
* The trainer: every regime trains through ``loop.main`` with
  ``dataDevice=1``; the batch stream is a function of (seed, step), so two
  runs, and a run and its autoResume'd twin, end bit-identical; the JAX
  refusals hold.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.data import device_data as jdd
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import device_data as dd
from video_filler_tpu_torch.data import synthetic
from video_filler_tpu_torch.train import loop
from video_filler_tpu_torch.utils.io import save_png

torch.set_num_threads(1)

TINY = dict(nef=8, ngf=8, ndf=8, nBottleneck=16, batchSize=2, nThreads=0,
            computeDtype="float32", niter=1, ntrain=4, manualSeed=222,
            display=False, checkpointEvery=5, dataDevice=True, wtl2=0.999)
CLI = ["device=cpu", "nef=8", "ngf=8", "ndf=8", "nBottleneck=16",
       "batchSize=2", "computeDtype=float32", "ntrain=4", "manualSeed=222",
       "display=0", "wtl2=0.999", "dataDevice=1"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A textured video corpus with its mask; a value-coded one (frame =
    50*video + t, so video 0 is dark); class folders of constant images
    (class a = 10, 40, 70; class b = 200); pairs (gt = 10i, masked =
    gt + 5)."""
    base = tmp_path_factory.mktemp("dd")
    vids = str(base / "vids")
    synthetic.make_video_corpus(vids, n_videos=2, frames=8, h=180, w=240)
    synthetic.make_mask_png(os.path.join(vids, "mask.png"), h=180, w=240)
    coded = str(base / "coded")
    for variant in ("gt", "gt1"):
        for v in range(2):
            for t in range(8):
                save_png(os.path.join(coded, variant, f"{t + 1:07d}_vid{v}"
                                      ".png"),
                         np.full((140, 160, 3), 50 * v + t, np.uint8))
    synthetic.make_mask_png(os.path.join(coded, "mask.png"), h=140, w=160)
    classes = str(base / "classes")
    for cls, values in (("a", (10, 40, 70)), ("b", (200,))):
        for i, val in enumerate(values):
            save_png(os.path.join(classes, cls, f"im_{i}.png"),
                     np.full((140, 150, 3), val, np.uint8))
    for i in range(6):
        save_png(str(base / "pairs" / "gt" / f"im_{i}.png"),
                 np.full((140, 150, 3), 10 * i, np.uint8))
        save_png(str(base / "pairs" / "masked" / f"im_{i}.png"),
                 np.full((140, 150, 3), 10 * i + 5, np.uint8))
    return {"vids": vids, "coded": coded, "classes": classes,
            "pairs": (str(base / "pairs" / "masked"),
                      str(base / "pairs" / "gt"))}


def _kw(roots, regime, **kw):
    """The options of a regime's data, over TINY."""
    if regime == "center":
        data = dict(DATA_ROOT=roots["classes"], loadSize=0)
    elif regime == "logo":
        data = dict(DATA_ROOT=roots["pairs"][0],
                    DATA_ROOT_GT=roots["pairs"][1], loadSize=0)
    else:
        data = dict(DATA_ROOT=roots["vids"], loadSize=150,
                    maskName=os.path.join(roots["vids"], "mask.png"))
        if regime != "wholeim":
            data["predLen"] = 2
        if regime == "video3d":
            data.update(loadSize=40, fineSize=32, video3dLevels=3)
    return {**TINY, **data, **kw}


def _corpus(roots, regime, **kw):
    """(port Opt, JAX arrays, JAX meta, port sampler, port arrays on the
    CPU)."""
    kw = _kw(roots, regime, **kw)
    opt = Opt(device="cpu", **kw)
    arrays, meta = jdd.load_corpus(JaxOpt(**kw), regime)
    sampler = dd.DeviceSampler(opt, regime, meta, "cpu")
    return opt, arrays, meta, sampler, dd.to_device(arrays, "cpu")


@pytest.mark.parametrize("regime", dd.SUPPORTED)
def test_load_corpus_equals_the_jax_one(roots, regime):
    kw = _kw(roots, regime, split=75)
    jarrays, jmeta = jdd.load_corpus(JaxOpt(**kw), regime)
    arrays, meta = dd.load_corpus(Opt(device="cpu", **kw), regime)
    assert len(arrays) == len(jarrays)
    for a, b in zip(arrays, jarrays):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert meta.keys() == jmeta.keys()
    for k in meta:
        np.testing.assert_array_equal(meta[k], jmeta[k])
        assert np.asarray(meta[k]).dtype == np.asarray(jmeta[k]).dtype, k


def test_wholeim_transform_equals_the_jax_transform(roots):
    """The JAX sampler's exposed transform on one frame with explicit
    (ch, cw, flip): corner cases of the translate and both flips."""
    kw = _kw(roots, "wholeim")
    (frames, mask3), meta = jdd.load_corpus(JaxOpt(**kw), "wholeim")
    jsample = jdd.make_device_sampler(JaxOpt(**kw), "wholeim", meta)
    img = frames[1, 3]
    cases = [(1, 1, False), (70, 100, True), (13, 57, True), (70, 1, False),
             (1, 100, False), (35, 64, True)]
    ch, cw, flip = (torch.tensor([c[i] for c in cases]) for i in range(3))
    got = dd.wholeim_transform(Opt(device="cpu", **kw),
                               torch.from_numpy(img)[None],
                               torch.from_numpy(mask3),
                               torch.zeros(len(cases), dtype=torch.long),
                               ch, cw, flip.bool())
    for i, (c, w, f) in enumerate(cases):
        want = jsample.transform(jnp.asarray(img), jnp.asarray(mask3), c, w,
                                 f)
        for g, j in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(j))
        assert float(got[3][i]) == pytest.approx(float(want[3]), rel=1e-6)


@pytest.mark.parametrize("regime", ["center", "logo", "video", "video3d"])
def test_gathers_equal_slices_of_the_jax_arrays(roots, regime):
    """Explicit decisions, the extreme crop offsets among them, against
    numpy slicing of the JAX load_corpus arrays; clips folded frame-major
    (np.concatenate of the frames on channels)."""
    opt, arrays, meta, sampler, dev = _corpus(roots, regime)
    fs, (h, w) = opt.fineSize, meta["hw"]
    y = torch.tensor([0, h - fs - 1, 3])
    x = torch.tensor([w - fs - 1, 0, 7])
    if regime in ("center", "logo"):
        idx = torch.tensor([0, arrays[0].shape[0] - 1, 2])
        got = sampler.gather(dev, {"index": idx, "y": y, "x": x})
        keys = ["raw"] if regime == "center" else ["raw_masked", "raw_gt"]
        for key, a in zip(keys, arrays):
            want = np.stack([a[i, r:r + fs, c:c + fs]
                             for i, r, c in zip(idx, y, x)])
            np.testing.assert_array_equal(got[key].numpy(), want)
        return
    frames, mask1 = arrays
    pl = opt.predLen
    variant = torch.tensor([0, 1, 1])
    frame = torch.tensor([0, frames.shape[1] - pl, 5])
    got = sampler.gather(dev, {"variant": variant, "frame": frame, "y": y,
                               "x": x})
    for i in range(3):
        clip = frames[variant[i], frame[i]:frame[i] + pl,
                      y[i]:y[i] + fs, x[i]:x[i] + fs]
        np.testing.assert_array_equal(got["raw"][i].numpy(),
                                      np.concatenate(list(clip), axis=-1))
        np.testing.assert_array_equal(
            got["mask"][i].numpy(), mask1[y[i]:y[i] + fs, x[i]:x[i] + fs])


def test_center_sampler_is_class_uniform(roots):
    """Class b holds 1 of 4 images but takes ~1/2 of the draws (the
    two-level draw of data/dataset.lua:351-364)."""
    opt, _, _, sampler, dev = _corpus(roots, "center", batchSize=16)
    gen = torch.Generator().manual_seed(0)
    vals = []
    for _ in range(8):
        b = sampler(dev, gen)["raw"]
        assert b.shape == (16, opt.fineSize, opt.fineSize, 3)
        assert b.dtype == torch.uint8
        for crop in b:
            u = torch.unique(crop)
            assert u.numel() == 1 and int(u) in (10, 40, 70, 200)
            vals.append(int(u))
    # binomial(128, .5) within [44, 84] at ~3.7 sigma
    assert 44 <= sum(v == 200 for v in vals) <= 84
    assert sampler.stats == {"batches": 8, "rounds": 8, "syncs": 0}


def test_logo_sampler_pairs_stay_aligned(roots):
    opt, _, _, sampler, dev = _corpus(roots, "logo", batchSize=8)
    gen = torch.Generator().manual_seed(1)
    seen = set()
    for _ in range(4):
        b = sampler(dev, gen)
        gt, mk = b["raw_gt"].int(), b["raw_masked"].int()
        assert torch.equal(mk, gt + 5)
        for crop in gt:
            u = torch.unique(crop)
            assert u.numel() == 1 and int(u) % 10 == 0
            seen.add(int(u) // 10)
    assert len(seen) > 2


def test_video_sampler_clips_and_dark_rejection(roots):
    """Coded frames (value 50*video + t): each folded clip is predLen
    consecutive frames of one video, frame-major; video 0 is dark, so a
    clip of it is kept with p=0.05 per attempt: P(video 0) = 0.5*0.05 /
    (0.5 + 0.5*0.05) = 0.0476 per sample."""
    opt, _, _, sampler, dev = _corpus(
        roots, "video", DATA_ROOT=roots["coded"], loadSize=0, predLen=3,
        gt1Prob=0.0, maskName=os.path.join(roots["coded"], "mask.png"),
        batchSize=32)
    gen = torch.Generator().manual_seed(2)
    dark = 0
    for _ in range(16):
        b = sampler(dev, gen)
        raw = b["raw"]
        assert raw.shape == (32, opt.fineSize, opt.fineSize, 9)
        assert set(torch.unique(b["mask"]).tolist()) <= {0, 1}
        per_frame = raw.reshape(32, -1, 3, 3).transpose(1, 2).flatten(2)
        lo, hi = per_frame.amin(2).int(), per_frame.amax(2).int()
        assert torch.equal(lo, hi)                  # constant frames
        base = lo[:, 0]
        assert torch.equal(lo, base[:, None] + torch.arange(3))
        assert bool((base % 50 + 2 < 8).all())      # inside one video
        dark += int((base < 50).sum())
    # 512 samples: E = 24.4, sd 4.8; within [8, 45] at ~4 sigma
    assert 8 <= dark <= 45
    st = sampler.stats
    assert st["batches"] == 16 and st["syncs"] == st["rounds"] >= 16


def test_video_sampler_honours_the_variant_probability(roots):
    """gt1Prob=1 draws only variant gt1 (cumulative probabilities (0, 1));
    variant gt is poisoned with 255."""
    opt, arrays, meta, sampler, _ = _corpus(
        roots, "video", DATA_ROOT=roots["coded"], loadSize=0, predLen=1,
        gt1Prob=1.0, maskName=os.path.join(roots["coded"], "mask.png"),
        batchSize=4)
    frames = arrays[0].copy()
    frames[0] = 255
    dev = dd.to_device((frames, arrays[1]), "cpu")
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        assert bool((sampler(dev, gen)["raw"] < 255).all())


def _train(tmp, regime, *extra):
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        return loop.main([f"regime={regime}", *CLI, *extra])
    finally:
        os.chdir(cwd)


def _args(roots, regime):
    return [f"{k}={v}" for k, v in _kw(roots, regime).items()
            if k not in TINY]


@pytest.mark.parametrize("regime", dd.SUPPORTED)
def test_every_regime_trains_with_data_device(roots, regime, tmp_path,
                                              capsys):
    state = _train(tmp_path, regime, *_args(roots, regime), "niter=1",
                   f"name=dd_{regime}")
    assert state.step == 2
    for p in state.gen.parameters():
        assert bool(torch.isfinite(p).all())
    assert "resident on device" in capsys.readouterr().out


def test_with_init_cascade_runs_on_the_device_batch(roots, tmp_path):
    args = _args(roots, "video")
    _train(tmp_path, "video", *args, "niter=1", "checkpointEvery=1",
           "name=init")
    state = _train(tmp_path, "video", *args, "niter=1", "withInit=1",
                   f"initName={tmp_path / 'checkpoints' / 'init_1_state.npz'}",
                   "weight_nomask=0", "name=cascade")
    assert state.step == 2


def test_stream_is_a_function_of_seed_and_step(roots, tmp_path):
    """Two fresh runs end bit-identical, and a run stopped after epoch 1
    and autoResume'd ends bit-identical to the uninterrupted run: the
    resumed run replays the batches of steps 2-3."""
    args = [*_args(roots, "video"), "weight_nomask=0.05"]
    runs = [_train(tmp_path, "video", *args, "niter=2", f"name={n}")
            for n in ("a", "b")]
    _train(tmp_path, "video", *args, "niter=1", "checkpointEvery=1",
           "name=r")
    runs.append(_train(tmp_path, "video", *args, "niter=2",
                       "checkpointEvery=1", "autoResume=1", "name=r"))
    assert [r.step for r in runs] == [4, 4, 4]
    for other in runs[1:]:
        for p, q in zip(runs[0].gen.parameters(), other.gen.parameters()):
            assert torch.equal(p, q)
    other_seed = _train(tmp_path, "video", *args, "niter=2",
                        "manualSeed=223", "name=c")
    assert not all(torch.equal(p, q) for p, q in zip(
        runs[0].gen.parameters(), other_seed.gen.parameters()))


@pytest.mark.parametrize("extra,match", [
    (["loadSize=-1"], "deterministic loadSize"),
    (["display=1"], "display=1"),
    (["seqParallel=2"], "does not support seqParallel"),
    (["regime=center"], "uniform frame geometry"),
], ids=["loadSize", "display", "seqParallel", "geometry"])
def test_refusals(roots, tmp_path, extra, match):
    regime = "center" if extra == ["regime=center"] else "video"
    args = _args(roots, "video")
    if regime == "center":
        mixed = tmp_path / "mixed"
        synthetic.make_image_folder(str(mixed / "a"), n=2, h=140, w=150)
        synthetic.make_image_folder(str(mixed / "b"), n=1, h=150, w=140)
        args, extra = [f"DATA_ROOT={mixed}", "loadSize=0"], []
    with pytest.raises(SystemExit, match=match):
        _train(tmp_path, regime, *args, *extra, "niter=1")
