"""The port's host data code against the JAX package's: samplers fed the
same RandomState give byte-identical batches (the JAX side on its Python
decode path, VF_NO_NATIVE=1), on synthetic corpora both packages write
identically."""

import filecmp
import os

import numpy as np
import pytest

from video_filler_tpu.config import Opt as JaxOpt
from video_filler_tpu.data import index as jindex
from video_filler_tpu.data import pipeline as jpipe
from video_filler_tpu.data import synthetic as jsynth
from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import index as tindex
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
