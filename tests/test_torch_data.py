"""The port's host data code against the JAX package's: samplers fed the
same RandomState give byte-identical batches, on the Python decode path
(VF_NO_NATIVE=1) and on the native one, on synthetic corpora both packages
write identically; the port's native decode against its Python decode and
the JAX package's native decode."""

import filecmp
import os
import subprocess

import numpy as np
import pytest

from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.data import index as jindex
from video_filler_tpu.data import pipeline as jpipe
from video_filler_tpu.data import synthetic as jsynth
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.ops.cuda.build import BUILD_DIR
from video_filler_tpu_torch.data import decode as tdecode
from video_filler_tpu_torch.data import index as tindex
from video_filler_tpu_torch.data import native as tnative
from video_filler_tpu_torch.data import pipeline as tpipe
from video_filler_tpu_torch.data import synthetic as tsynth


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A video corpus with its logo mask, and masked/gt pair folders whose
    images are smaller than a 128 crop (the samplers upscale them)."""
    root = tmp_path_factory.mktemp("data")
    tsynth.make_video_corpus(str(root / "corpus"), n_videos=2, frames=8,
                             h=180, w=240)
    tsynth.make_mask_png(str(root / "mask.png"), h=180, w=240,
                         box=(60, 80, 120, 200))
    masked, gt = tsynth.make_paired_folders(str(root / "pairs"), n=6,
                                            h=120, w=150)
    return root, masked, gt


def test_synthetic_fixtures_match_the_jax_package(tmp_path):
    for mod, sub in ((tsynth, "t"), (jsynth, "j")):
        d = tmp_path / sub
        mod.make_video_corpus(str(d / "corpus"), n_videos=1, frames=3,
                              h=40, w=50, seed=2)
        mod.make_mask_png(str(d / "mask.png"), h=40, w=50, box=(5, 6, 20, 30))
        mod.make_paired_folders(str(d / "pairs"), n=2, h=40, w=50, seed=3)
    files = sorted(os.path.relpath(os.path.join(dp, f), tmp_path / "t")
                   for dp, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert len(files) == 3 * 2 + 1 + 2 * 2
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "t", tmp_path / "j",
                                           files, shallow=False)
    assert mismatch == [] and errors == []


def test_indexes_sample_as_the_jax_package(corpora):
    root, masked, gt = corpora
    for split in (100, 60):
        a = tindex.VideoCorpus(str(root / "corpus"), split=split)
        b = jindex.VideoCorpus(str(root / "corpus"), split=split)
        assert (a.suffixes, a.counts, a.starts, a.pad) == \
            (b.suffixes, b.counts, b.starts, b.pad)
        for part in ("train", "test") if split < 100 else ("train",):
            assert a.size(part) == b.size(part)
            ra, rb = np.random.RandomState(4), np.random.RandomState(4)
            assert [a.sample_clip(ra, 2, part) for _ in range(10)] == \
                [b.sample_clip(rb, 2, part) for _ in range(10)]
        pa, pb = tindex.PairedIndex(masked, gt, split), \
            jindex.PairedIndex(masked, gt, split)
        ra, rb = np.random.RandomState(5), np.random.RandomState(5)
        assert pa.sample(ra, 7) == pb.sample(rb, 7)
    with pytest.raises(ValueError, match="differ in size"):
        tindex.PairedIndex(masked, str(root / "corpus" / "gt"))


def test_mask_load_and_rescale_match(corpora):
    root, _, _ = corpora
    m = tpipe.load_mask(str(root / "mask.png"))
    np.testing.assert_array_equal(m, jpipe.load_mask(str(root / "mask.png")))
    assert m.shape == (180, 240, 1) and set(np.unique(m)) == {0, 1}
    for hw in ((150, 200), (180, 240)):
        np.testing.assert_array_equal(tpipe._cached_mask_at(m, {}, *hw),
                                      jpipe._cached_mask_at(m, {}, *hw))


# case -> sampler options (video_undersized: frames below the 192 crop)
SAMPLERS = {
    "video": dict(predLen=2, loadSize=150),
    "video_undersized": dict(predLen=3, loadSize=0, fineSize=192),
    "video_nomask": dict(predLen=2, loadSize=150, maskName=""),
    "logo": dict(loadSize=0),
    "wholeim": dict(loadSize=150),
    "center": dict(loadSize=0),
}


@pytest.mark.parametrize("case", list(SAMPLERS))
def test_sampler_matches_the_jax_sampler_byte_for_byte(corpora, monkeypatch,
                                                       case):
    monkeypatch.setenv("VF_NO_NATIVE", "1")
    root, masked, gt = corpora
    regime = case.split("_")[0]
    kw = dict(batchSize=3, maskName=str(root / "mask.png"),
              DATA_ROOT=str(root / "corpus"))
    if regime == "logo":
        kw.update(DATA_ROOT=masked, DATA_ROOT_GT=gt)
    if regime == "center":
        kw.update(DATA_ROOT=gt)
    kw.update(SAMPLERS[case])
    ours, n_ours = tpipe.make_sampler(Opt(device="cpu", **kw), regime)
    ref, n_ref = jpipe.make_sampler(JaxOpt(**kw), regime)
    assert n_ours == n_ref
    ra, rb = np.random.RandomState(6), np.random.RandomState(6)
    for _ in range(2):
        a, b = ours(ra), ref(rb)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == np.uint8 and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if regime == "video" and kw["maskName"]:
        assert a["mask"].any()


def test_dark_crops_are_rejected_as_the_jax_sampler_does(tmp_path,
                                                          monkeypatch):
    """A corpus of mostly black frames: both samplers redraw dark crops
    with the same RandomState and land on the same clips."""
    monkeypatch.setenv("VF_NO_NATIVE", "1")
    root = tmp_path / "dark"
    tsynth.make_video_corpus(str(root), n_videos=2, frames=6, h=140,
                             w=150, seed=1)
    from video_filler_tpu.utils.io import save_png
    for variant in ("gt", "gt1"):
        for t in range(1, 5):               # video 0: 4 of 6 frames black
            save_png(str(root / variant / f"{t:07d}_vid0.png"),
                     np.zeros((140, 150, 3), np.uint8))
    kw = dict(batchSize=4, predLen=2, loadSize=0, DATA_ROOT=str(root))
    ours, _ = tpipe.make_sampler(Opt(device="cpu", **kw), "video")
    ref, _ = jpipe.make_sampler(JaxOpt(**kw), "video")
    ra, rb = np.random.RandomState(7), np.random.RandomState(7)
    a, b = ours(ra), ref(rb)
    np.testing.assert_array_equal(a["raw"], b["raw"])
    assert ra.randint(1 << 30) == rb.randint(1 << 30)   # same draws made


def test_make_sampler_refusals_match(corpora):
    root, masked, gt = corpora
    with pytest.raises(ValueError, match="requires maskName"):
        tpipe.make_sampler(Opt(device="cpu", DATA_ROOT=str(root / "corpus")),
                           "wholeim")
    with pytest.raises(ValueError, match="split < 100"):
        tpipe.make_sampler(Opt(device="cpu", DATA_ROOT=str(root / "corpus")),
                           "video", split="test")
    with pytest.raises(ValueError, match="unknown regime"):
        tpipe.make_sampler(Opt(device="cpu"), "video4d")


# --- the native decode (data/native.py, csrc/vf_native.cpp) ---------------

@pytest.fixture(scope="module")
def toolchain():
    """What the native build needs: g++ with jpeglib.h and png.h."""
    probe = "#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"
    try:
        ok = subprocess.run(["g++", "-E", "-x", "c++", "-"], input=probe,
                            capture_output=True, text=True,
                            timeout=60).returncode == 0
    except OSError:
        ok = False
    if not ok:
        pytest.skip("no g++ with jpeglib.h and png.h to build vf_native")
    assert tnative.available(), tnative.unavailable_reason()


def test_native_decode_is_the_python_decode_and_the_jax_native(corpora,
                                                              toolchain):
    """Without a resample (PNG frames at their own size) the native decode
    is the Python decode byte for byte; with one (loadSize 150) it is the
    JAX package's native decode byte for byte and the Python decode within
    the JAX suite's bound (mean |diff| < 2, another bilinear resampler)."""
    from video_filler_tpu.data import native as jnative
    root, _, _ = corpora
    paths = sorted(str(p) for p in (root / "corpus" / "gt").iterdir())[:4]
    clips = [paths[i:i + 2] for i in range(3)]
    seeds = np.arange(1, 4, dtype=np.uint64)
    for load in (180, 150):      # the frames' short side: no resample
        got = tnative.load_frames(paths, load, 180, 240)
        jgot = jnative.load_frames(paths, load, 180, 240)
        np.testing.assert_array_equal(got[1], jgot[1])
        assert got[2] == jgot[2] == 0
        for i, p in enumerate(paths):
            h, w = got[1][i]          # the slot beyond (h, w) is unwritten
            np.testing.assert_array_equal(got[0][i, :h, :w],
                                          jgot[0][i, :h, :w])
            ref = tdecode.load_and_resize(p, load)
            assert (h, w) == ref.shape[:2]
            if load == 180:
                assert got[0][i, :h, :w].tobytes() == ref.tobytes()
            else:
                assert np.abs(got[0][i, :h, :w].astype(int)
                              - ref.astype(int)).mean() < 2.0
        out, offs, fails = tnative.load_clips(clips, load, 128, seeds)
        jout, joffs, _ = jnative.load_clips(clips, load, 128, seeds)
        assert fails == 0
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(offs, joffs)
        if load == 180:
            for i, clip in enumerate(clips):
                y, x = offs[i, :2]
                ref = np.concatenate([tdecode.decode_image(p) for p in clip],
                                     axis=-1)[y:y + 128, x:x + 128]
                assert out[i].tobytes() == ref.tobytes()
    assert tnative.image_size(paths[0]) == jnative.image_size(paths[0])


NATIVE_SAMPLERS = {"center": dict(loadSize=140), "logo": dict(loadSize=130),
                   "video": dict(predLen=2, loadSize=150),
                   "wholeim": dict(loadSize=150)}


@pytest.mark.parametrize("regime", list(NATIVE_SAMPLERS))
def test_native_samplers_match_the_jax_native_samplers(corpora, monkeypatch,
                                                       toolchain, regime):
    """With the native decode on in both packages, the port's sampler takes
    its native path (counted) and gives the JAX sampler's batches."""
    monkeypatch.delenv("VF_NO_NATIVE", raising=False)
    root, masked, gt = corpora
    kw = dict(batchSize=3, maskName=str(root / "mask.png"),
              DATA_ROOT=str(root / "corpus"), **NATIVE_SAMPLERS[regime])
    if regime == "logo":
        kw.update(DATA_ROOT=masked, DATA_ROOT_GT=gt)
    if regime == "center":
        kw.update(DATA_ROOT=gt)
    calls = []
    for fn in ("load_clips", "load_frames"):
        real = getattr(tnative, fn)
        monkeypatch.setattr(tpipe.native, fn,
                            lambda *a, _f=real, **k: calls.append(1)
                            or _f(*a, **k))
    ours, _ = tpipe.make_sampler(Opt(device="cpu", **kw), regime)
    ref, _ = jpipe.make_sampler(JaxOpt(**kw), regime)
    ra, rb = np.random.RandomState(8), np.random.RandomState(8)
    a, b = ours(ra), ref(rb)
    assert calls and a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_native_builds_under_build_and_records_a_failure(tmp_path,
                                                         monkeypatch,
                                                         toolchain):
    """The port's library is its own, under build/video_filler_tpu_torch/
    (never native/libvf_native.so); a failed build leaves the reason."""
    so = tnative.library_path()
    assert os.path.dirname(so) == BUILD_DIR and os.path.isfile(so)
    assert tnative._lib._name == so
    assert os.path.basename(so).startswith("libvf_native-")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    assert not tnative.available()
    assert "g++ failed" in tnative.unavailable_reason()
    with pytest.raises(RuntimeError, match="vf_native is unavailable"):
        tnative.image_size(str(bad))
    assert not os.listdir(tmp_path / "build")
