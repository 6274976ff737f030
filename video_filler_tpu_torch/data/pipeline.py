"""Host data pipeline: per-regime batch samplers and the threaded prefetch
pump, copied from video_filler_tpu/data/pipeline.py (the port imports
nothing of the JAX package).  Decode runs on the native C++ pool
(data/native.py) where it builds, as in the JAX package; the Python decode
(data/decode.py) is the reference and the per-image fallback, and the only
path with ``VF_NO_NATIVE=1``.

Samplers return uint8 numpy batches; flip, normalisation and mask synthesis
run on the device (train/step.py ``make_preprocess``).  Each reproduces a
donkey of the reference:
* center  -- data/donkey_folder.lua:70-88 (short-side resize, random crop)
* logo    -- data/donkey_folder_logo.lua:72-99 (paired images, SAME crop)
* video   -- datavid/donkey_folder.lua:138-186 (predLen frames channel-folded,
             global mask rescaled to the clip, dark-crop rejection)
* wholeim -- datavid/donkey_wholeim.lua:141-216 (mask-fill, random translate
             crop, hflip p=0.4, 3x3 patch slicing, 2x2 target corner)
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable

import numpy as np

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import decode, native
from video_filler_tpu_torch.data.index import (
    FolderIndex,
    PairedIndex,
    VideoCorpus,
)
from video_filler_tpu_torch.ops.masks import binarize_mask

Batch = dict[str, np.ndarray]


def _use_native(opt: Opt) -> bool:
    """Native C++ decode path: RGB only, fixed-size crops, loadSize >= 0
    (the random-scale modes stay in Python)."""
    return (opt.nc == 3 and opt.loadSize >= 0 and native.available()
            and os.environ.get("VF_NO_NATIVE") != "1")


def _random_crop_hw(rs, h, w, ch, cw):
    """Uniform crop offsets; Lua `math.ceil(torch.uniform(1e-2, iH-oH))` is
    1..iH-oH inclusive (1-based) == 0..iH-oH-1 0-based, i.e. the last oH rows
    can never start a crop at the extreme — match the uniform range."""
    y = rs.randint(0, max(h - ch, 1))
    x = rs.randint(0, max(w - cw, 1))
    return y, x


def center_sampler(opt: Opt, index: FolderIndex,
                   split: str = "train") -> Callable:
    """Random image → short-side resize → random fineSize crop; uint8 out
    (data/donkey_folder.lua:70-88).  Uses the native C++ parallel decode
    path (data/native.py) when available, falling back per image to Python
    for files the native decoder rejects.  `split` selects the folder
    dataset's train/test portion."""
    fs = opt.fineSize
    use_native = _use_native(opt)

    def _python_one(rs, p):
        img = decode.load_and_resize(p, opt.loadSize, opt.nc, rs)
        h, w = img.shape[:2]
        if h < fs or w < fs:
            img = decode.resize(img, max(h, fs), max(w, fs))
            h, w = img.shape[:2]
        y, x = _random_crop_hw(rs, h, w, fs, fs)
        return img[y:y + fs, x:x + fs]

    def sample(rs: np.random.RandomState) -> Batch:
        paths = index.sample(rs, opt.batchSize, split=split)
        if use_native:
            seeds = rs.randint(1, 2**63, size=opt.batchSize, dtype=np.uint64)
            out, offs, fails = native.load_clips([[p] for p in paths],
                                                 opt.loadSize, fs, seeds)
            if fails:
                for i, p in enumerate(paths):
                    if offs[i, 2] == 0:  # per-clip failure flag
                        out[i] = _python_one(rs, p)
            return {"raw": out}
        out = np.empty((opt.batchSize, fs, fs, opt.nc), np.uint8)
        for i, p in enumerate(paths):
            out[i] = _python_one(rs, p)
        return {"raw": out}

    return sample


def logo_sampler(opt: Opt, paired: PairedIndex,
                 split: str = "train") -> Callable:
    """Masked/gt pairs with the SAME crop applied to both
    (data/donkey_folder_logo.lua:72-99; the flip happens on the device, also
    shared).  Decode + resize of the 2B images per batch runs on the native
    pool when available; the per-image Python fallback keeps the error
    semantics (a pair size mismatch still raises) either way.  ``split``
    selects the train head / held-out tail of the pair list
    (PairedIndex.split)."""
    fs = opt.fineSize
    use_native = _use_native(opt) and opt.loadSize > 0
    max_hw = opt.loadSize * 2
    slots = threading.local()  # per-worker slot buffer, reused across batches

    def sample(rs: np.random.RandomState) -> Batch:
        masked = np.empty((opt.batchSize, fs, fs, opt.nc), np.uint8)
        gt = np.empty_like(masked)
        pairs = paired.sample(rs, opt.batchSize, split=split)
        buf = hw = None
        if use_native:
            if getattr(slots, "buf", None) is None:
                slots.buf = np.empty((2 * opt.batchSize, max_hw, max_hw, 3),
                                     np.uint8)
            flat = [p for pair in pairs for p in pair]  # masked, gt, ...
            buf, hw, _fails = native.load_frames(flat, opt.loadSize,
                                                 max_hw, max_hw,
                                                 out=slots.buf)
        for i, (pm, pg) in enumerate(pairs):
            # A pair decodes with ONE decoder: if either image fell back
            # (a decode error in the native pool), redo BOTH in Python so
            # the size-equality check below compares like with like -- the
            # two paths share the half-up size rule but not the resampler.
            if buf is not None and hw[2 * i, 0] != 0 and hw[2 * i + 1, 0] != 0:
                im = buf[2 * i, :hw[2 * i, 0], :hw[2 * i, 1]]
                ig = buf[2 * i + 1, :hw[2 * i + 1, 0], :hw[2 * i + 1, 1]]
            else:
                im = decode.load_and_resize(pm, opt.loadSize, opt.nc)
                ig = decode.load_and_resize(pg, opt.loadSize, opt.nc)
            if im.shape != ig.shape:
                raise ValueError(
                    f"paired images differ in size: {pm} vs {pg} "
                    "(donkey_folder_logo.lua:77-78 asserts equality)")
            h, w = im.shape[:2]
            if h < fs or w < fs:
                # Undersized frames (loadSize=0 or < fineSize): upscale so
                # the crop fits, matching center_sampler._python_one -- same
                # resize for both halves keeps the pair aligned.
                im = decode.resize(im, max(h, fs), max(w, fs))
                ig = decode.resize(ig, max(h, fs), max(w, fs))
                h, w = im.shape[:2]
            y, x = _random_crop_hw(rs, h, w, fs, fs)
            masked[i] = im[y:y + fs, x:x + fs]
            gt[i] = ig[y:y + fs, x:x + fs]
        return {"raw_masked": masked, "raw_gt": gt}

    return sample


def load_mask(path: str, mode: str = "byte") -> np.ndarray:
    """Load a logo mask PNG -> (H, W, 1) uint8 {0,1}
    (datavid/donkey_folder.lua:29-35)."""
    img = decode.decode_image(path, nc=1)
    return binarize_mask(img.astype(np.float32) / 255.0, mode)


def _cached_mask_at(mask: np.ndarray, cache: dict, h: int, w: int
                    ) -> np.ndarray:
    """``mask`` rescaled to (h, w) with the >=128 binarization (the donkeys
    rescale the global mask to each frame, datavid/donkey_folder.lua:109),
    memoized per geometry -- corpus frames share one size."""
    m = cache.get((h, w))
    if m is None:
        m = mask
        if m.shape[:2] != (h, w):
            m = (decode.resize((m * 255).astype(np.uint8), h, w)
                 >= 128).astype(np.uint8)
        cache[(h, w)] = m
    return m


def video_sampler(opt: Opt, corpus: VideoCorpus,
                  mask: np.ndarray | None, split: str = "train") -> Callable:
    """predLen consecutive frames channel-folded + the (rescaled, cropped)
    logo mask.  Dark crops (mean < 0.1) are rejected and resampled with keep
    probability 0.05 (datavid/donkey_folder.lua:150-155,
    datavid/dataset.lua:407-421) -- data-dependent, so it stays host-side.
    The random-block fallback for empty mask crops runs on the device.
    ``split`` draws clips from the corpus's train head / held-out tail."""
    fs, pl, nc = opt.fineSize, opt.predLen, opt.nc
    use_native = _use_native(opt)
    fallback_warned = [False]  # one notice per sampler, not per clip
    mask_cache: dict[tuple[int, int], np.ndarray] = {}

    def _mask_crop(h, w, y, x):
        if mask is None:
            return np.zeros((fs, fs, 1), np.uint8)
        return _cached_mask_at(mask, mask_cache, h, w)[y:y + fs, x:x + fs]

    def sample_native(rs: np.random.RandomState) -> Batch:
        """Batch decode via C++ (a shared crop per clip and its reported
        offsets for the mask); dark clips are rejected and redrawn in later
        rounds."""
        b = opt.batchSize
        raw = np.empty((b, fs, fs, nc * pl), np.uint8)
        msk = np.empty((b, fs, fs, 1), np.uint8)
        pending = list(range(b))
        while pending:
            clips = [corpus.sample_clip(rs, pl, split) for _ in pending]
            seeds = rs.randint(1, 2**63, size=len(pending), dtype=np.uint64)
            out, offs, _fails = native.load_clips(clips, opt.loadSize, fs,
                                                  seeds)
            still = []
            for j, i in enumerate(pending):
                if offs[j, 2] == 0:  # per-clip failure flag (decode error,
                    # short side < crop, or mismatched frame sizes -- the
                    # native side zeroes rh for every failure mode).  Python-
                    # decode THIS clip: it upscales undersized frames and
                    # raises naming the file on corrupt data, so native
                    # availability changes neither which configs work nor
                    # which files are skipped.
                    if not fallback_warned[0]:
                        fallback_warned[0] = True
                        print("vf_native: clip rejected (undersized/"
                              f"mismatched/corrupt: {clips[j][0]} ...); "
                              "falling back to Python decode for such clips")
                    r = _python_clip(rs, clips[j])
                    if r is None:
                        still.append(i)  # dark crop: redraw like any other
                    else:
                        raw[i], msk[i] = r
                    continue
                if out[j].mean() < 0.1 * 255 and rs.rand() <= 0.95:
                    still.append(i)  # dark-crop rejection: redraw
                    continue
                raw[i] = out[j]
                y, x, rh, rw = offs[j]
                msk[i] = _mask_crop(rh, rw, y, x)
            pending = still
        return {"raw": raw, "mask": msk}

    def _python_clip(rs, paths):
        """Decode + crop one clip.  Returns (crop, mask_crop), or None when
        the dark-crop rule rejects it (the caller redraws)."""
        frames = [decode.decode_image(p, nc) for p in paths]
        clip = np.concatenate(frames, axis=-1)              # (H, W, nc*pl)
        clip = decode.short_side_resize(clip, opt.loadSize, rs)
        h, w = clip.shape[:2]
        if h < fs or w < fs:
            # Undersized frames (loadSize=0 or < fineSize): upscale so the
            # crop fits, matching center_sampler._python_one.
            clip = decode.resize(clip, max(h, fs), max(w, fs))
            h, w = clip.shape[:2]
        y, x = _random_crop_hw(rs, h, w, fs, fs)
        crop = clip[y:y + fs, x:x + fs]
        if crop.mean() < 0.1 * 255 and rs.rand() <= 0.95:
            return None  # reject nearly-black crop
        return crop, _mask_crop(h, w, y, x)

    def sample_one(rs):
        while True:
            r = _python_clip(rs, corpus.sample_clip(rs, pl, split))
            if r is not None:
                return r

    def sample(rs: np.random.RandomState) -> Batch:
        if use_native:
            return sample_native(rs)
        raw = np.empty((opt.batchSize, fs, fs, nc * pl), np.uint8)
        msk = np.empty((opt.batchSize, fs, fs, 1), np.uint8)
        for i in range(opt.batchSize):
            raw[i], msk[i] = sample_one(rs)
        return {"raw": raw, "mask": msk}

    return sample


def wholeim_sampler(opt: Opt, corpus: VideoCorpus,
                    mask: np.ndarray, split: str = "train") -> Callable:
    """Patch-array regime (datavid/donkey_wholeim.lua:141-216): mask-fill
    the frame, random translate-crop (<= 100x70 px, zero re-padded), hflip
    p=0.4, slice arrh x arrw overlapping fineSize patches into channels;
    targets = top-left 2x2 patches + their mask.  The full-frame decode and
    resize run on the native pool when available; frames it rejects fall
    back to Python decode one by one, with the same error semantics."""
    fs = opt.fineSize
    arrh, arrw = opt.array_h, opt.array_w
    outh, outw = opt.out_h, opt.out_w
    nc = opt.nc
    fill = int(round(opt.maskValue * 255.0))
    # loadSize>0 bounds the resized frame: short side == loadSize, long side
    # capped at 2x (beyond -> per-frame Python fallback, no slot limit there).
    use_native = _use_native(opt) and opt.loadSize > 0
    max_hw = opt.loadSize * 2
    slots = threading.local()  # per-worker slot buffer, reused across batches
    mask_cache: dict[tuple[int, int], np.ndarray] = {}

    def _transform(rs, img):
        """Mask-fill + translate + flip + dark-check + slice one decoded
        frame; None = dark-rejected (the caller redraws)."""
        h, w = img.shape[:2]
        if h < fs or w < fs:
            # Undersized frames: upscale so the patch grid fits (steph/stepw
            # below go negative for h < fs), as the other samplers do.
            img = decode.resize(img, max(h, fs), max(w, fs))
            h, w = img.shape[:2]
        m3 = np.broadcast_to(_cached_mask_at(mask, mask_cache, h, w),
                             img.shape)
        masked_img = np.where(m3 > 0, np.uint8(fill), img)

        # random translate-crop, content shifted toward the origin and the
        # freed border zero-padded (donkey_wholeim.lua:168-174)
        cw, ch_ = rs.randint(1, 101), rs.randint(1, 71)

        def translate(a):
            out = np.zeros_like(a)
            out[: h - ch_ + 1, : w - cw + 1] = a[ch_ - 1:, cw - 1:]
            return out

        img_t, m_t, masked_t = translate(img), translate(m3), \
            translate(masked_img)
        if rs.rand() > 0.6:  # hflip p=0.4
            img_t, m_t, masked_t = (np.ascontiguousarray(a[:, ::-1])
                                    for a in (img_t, m_t, masked_t))
        if img_t[:fs, :fs].mean() < 0.1 * 255 and rs.rand() <= 0.9:
            return None  # dark top-left patch rejection (keep p=0.1)

        steph = (h - fs) // (arrh - 1)
        stepw = (w - fs) // (arrw - 1)
        masked_patches = np.empty((fs, fs, nc * arrh * arrw), np.uint8)
        out_patches = np.empty((fs, fs, nc * outh * outw), np.uint8)
        mask_patches = np.zeros((fs, fs, nc * outh * outw), np.uint8)
        pi = 0
        for hi in range(arrh):
            for wi in range(arrw):
                y, x = hi * steph, wi * stepw
                masked_patches[..., pi * nc:(pi + 1) * nc] = \
                    masked_t[y:y + fs, x:x + fs]
                if hi < outh and wi < outw:
                    oi = hi * outw + wi
                    out_patches[..., oi * nc:(oi + 1) * nc] = \
                        img_t[y:y + fs, x:x + fs]
                    mask_patches[..., oi * nc:(oi + 1) * nc] = \
                        m_t[y:y + fs, x:x + fs]
                pi += 1
        return masked_patches, out_patches, mask_patches

    def sample_one(rs):
        while True:
            path = corpus.sample_clip(rs, 1, split)[0]
            r = _transform(rs, decode.load_and_resize(path, opt.loadSize,
                                                      nc, rs))
            if r is not None:
                return r

    def sample(rs: np.random.RandomState) -> Batch:
        b = opt.batchSize
        masked = np.empty((b, fs, fs, nc * arrh * arrw), np.uint8)
        real = np.empty((b, fs, fs, nc * outh * outw), np.uint8)
        msk = np.empty((b, fs, fs, nc * outh * outw), np.uint8)
        if not use_native:
            for i in range(b):
                masked[i], real[i], msk[i] = sample_one(rs)
            return {"raw_masked": masked, "raw_real": real, "mask": msk}
        if getattr(slots, "buf", None) is None:
            slots.buf = np.empty((b, max_hw, max_hw, 3), np.uint8)
        pending = list(range(b))
        while pending:
            paths = [corpus.sample_clip(rs, 1, split)[0] for _ in pending]
            buf, hw, _fails = native.load_frames(paths, opt.loadSize,
                                                 max_hw, max_hw,
                                                 out=slots.buf)
            still = []
            for j, i in enumerate(pending):
                if hw[j, 0] == 0:  # native rejection: Python-decode THIS
                    # frame (a descriptive error on corrupt data)
                    img = decode.load_and_resize(paths[j], opt.loadSize,
                                                 nc, rs)
                else:
                    img = buf[j, :hw[j, 0], :hw[j, 1]]
                r = _transform(rs, img)
                if r is None:
                    still.append(i)  # dark: redraw like the Python path
                    continue
                masked[i], real[i], msk[i] = r
            pending = still
        return {"raw_masked": masked, "raw_real": real, "mask": msk}

    return sample


def make_sampler(opt: Opt, regime: str, split: str = "train"):
    """(sampler, dataset_size) for a regime from the Opt's data roots;
    video3d shares the video sampler (its preprocess unfolds the clip).

    ``split``: the folder dataset splits per class
    (data/dataset.lua:263-309); the video corpora reserve a held-out tail
    frame range per video (Opt.split < 100); the logo pairs a held-out tail
    of the sorted pair list."""
    if regime == "center":
        index = FolderIndex(opt.DATA_ROOT, split=opt.split,
                            cache_dir=opt.cacheDir or None)
        return center_sampler(opt, index, split=split), index.size(split)
    if regime == "logo":
        paired = PairedIndex(opt.DATA_ROOT, opt.DATA_ROOT_GT, split=opt.split)
        if split != "train" and opt.split >= 100:
            raise ValueError(
                "evalSplit='test' needs split < 100 to reserve a held-out "
                "tail of the pair list (PairedIndex.split)")
        return logo_sampler(opt, paired, split=split), paired.size(split)
    if regime not in ("video", "video3d", "wholeim"):
        raise ValueError(f"unknown regime {regime!r}")
    mask = load_mask(opt.maskName) if opt.maskName else None
    corpus_kw = {}
    if opt.vidExts:
        corpus_kw["suffixes"] = opt.vidExts.split(",")
        corpus_kw["counts"] = [int(c) for c in opt.vidCounts.split(",")]
    corpus = VideoCorpus(opt.DATA_ROOT,
                         variants=(("gt", 1.0 - opt.gt1Prob),
                                   ("gt1", opt.gt1Prob)),
                         split=opt.split,
                         **corpus_kw)
    if split != "train" and opt.split >= 100:
        raise ValueError(
            "evalSplit='test' needs split < 100 to reserve a held-out tail "
            "range per video (VideoCorpus.split)")
    if regime in ("video", "video3d"):
        return video_sampler(opt, corpus, mask, split), corpus.size(split)
    if mask is None:
        raise ValueError("wholeim regime requires maskName")
    return wholeim_sampler(opt, corpus, mask, split), corpus.size(split)


class DataLoader:
    """Threaded prefetch pump (data/data.lua semantics, Python threads).

    n_threads workers each own a RandomState(seed + tid) (the reference seeds
    each donkey manualSeed+idx, data/data.lua:31-33) and keep the bounded
    queue full; ``get_batch`` pops.  n_threads=0 = synchronous (data/data.lua:41-47).
    """

    def __init__(self, sample_fn: Callable, n_threads: int, seed: int = 0,
                 prefetch_depth: int = 2):
        self._sample = sample_fn
        self._n = n_threads
        if n_threads == 0:
            self._rs = np.random.RandomState(seed)
            return
        self._q: queue.Queue = queue.Queue(maxsize=max(n_threads, 1)
                                           * prefetch_depth)
        self._stop = threading.Event()
        self._threads = []
        for tid in range(n_threads):
            t = threading.Thread(target=self._worker, args=(seed + 1 + tid,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, seed: int) -> None:
        rs = np.random.RandomState(seed)
        while not self._stop.is_set():
            try:
                batch = self._sample(rs)
            except BaseException as e:  # noqa: BLE001 — deliver to consumer:
                # a silently-dead worker starves the queue and get_batch
                # would hang forever once every worker has died
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, BaseException):
                return  # this worker exits after reporting its failure

    def get_batch(self) -> Batch:
        if self._n == 0:
            return self._sample(self._rs)
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item  # re-raise a worker's failure on the consumer thread
        return item

    def close(self) -> None:
        if self._n:
            self._stop.set()
            for t in self._threads:
                t.join(timeout=2.0)
