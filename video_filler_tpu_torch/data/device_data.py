"""Device-resident dataset (``dataDevice=1``): the counterpart of
video_filler_tpu/data/device_data.py for every training regime.

The train split is decoded ONCE on the host (``load_corpus``, the JAX
package's arrays and tables byte for byte), copied to the training device
as uint8 (``to_device``), and every training batch is synthesised there by
``DeviceSampler`` from a ``torch.Generator`` on that device: indexing into
the resident corpus replaces the host sampler threads and the per-step
host->device batch copy.  The output is the host sampler's batch dict, as
uint8 tensors on the device, so train/step.py's ``make_preprocess``
consumes it unchanged.

Each regime's sampler is split into ``draws`` (the random decisions, from
the generator) and ``gather`` (indexing the corpus with them), so a test
can hand the gather explicit decisions.  The decisions mirror the host
samplers' distributions (and the JAX sampler's):

* center  -- uniform class -> uniform image -> uniform fineSize crop
             (data/donkey_folder.lua:70-88 via pipeline.center_sampler);
* logo    -- uniform pair -> the SAME uniform crop on both halves
             (data/donkey_folder_logo.lua:72-99; the shared flip runs in
             make_preprocess);
* video / video3d -- uniform video -> uniform clip start -> gt-variant by
             cumulative probability, predLen frames channel-folded frame-
             major, a crop shared with the mask's, dark-crop rejection with
             keep p=0.05 (datavid/donkey_folder.lua:138-186);
* wholeim -- the donkey transform: mask-fill, a translate of up to 70x100
             px toward the origin (the freed border zero), hflip p=0.4, dark
             top-left rejection with keep p=0.1, and the arrh x arrw patch
             grid in (hi, wi) order (donkey_wholeim.lua:141-216).

Rejection: the JAX sampler loops on the device per sample
(``lax.while_loop``).  Here each round draws ``ATTEMPTS`` candidates per
pending sample in one batched pass, takes each sample's first accepted
candidate, and goes round again only for samples with none: a sample is
accepted on its first non-rejected attempt, as in JAX, at one host sync per
round (``nonzero`` of the pending set).  center and logo have no rejection
and no sync.  ``stats`` counts batches, rounds and syncs.

Streams: the trainer seeds the generator per global step, so a batch is a
pure function of (seed, step) on a given device type and an autoResume'd
run replays the uninterrupted run's stream exactly.  CPU and CUDA
generators give different streams (as threefry and numpy's MT do across
the packages): a dataDevice run is another valid sample sequence than a
host-loader run, or than the JAX package's.

Requires uniform frame geometry after the loadSize resize and a
deterministic loadSize (>= 0); raises otherwise, with the JAX package's
words.
"""

from __future__ import annotations

import numpy as np
import torch

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import decode
from video_filler_tpu_torch.data.index import (
    FolderIndex,
    PairedIndex,
    VideoCorpus,
)
from video_filler_tpu_torch.data.pipeline import _cached_mask_at, load_mask

SUPPORTED = ("center", "logo", "video", "video3d", "wholeim")

# The wholeim donkey's translate-crop bounds (donkey_wholeim.lua:168-170):
# content shifts toward the origin by (ch-1, cw-1), ch in [1,70], cw in
# [1,100].
_TRANS_H, _TRANS_W = 70, 100

# Dark-crop rejection: mean below 0.1 * 255, rejected with probability
# 0.95 (video) or 0.9 (wholeim) -- a uniform draw u <= p rejects.
_DARK = 0.1 * 255.0
_REJECT_P = {"video": 0.95, "video3d": 0.95, "wholeim": 0.9}


def check_regime(opt: Opt, regime: str) -> None:
    """The JAX sampler's ``_check_regime``: a regime outside ``SUPPORTED``
    or a random-scale loadSize is refused."""
    if regime not in SUPPORTED:
        raise SystemExit(
            f"dataDevice=1 supports regimes {SUPPORTED}, not {regime!r} — "
            "use the host pipeline (nThreads=N) for this regime")
    if opt.loadSize < 0:
        raise SystemExit(
            "dataDevice=1 requires a deterministic loadSize (>= 0): the "
            "random-scale modes (loadSize < 0) re-draw a scale per sample, "
            "which the one-shot device cache cannot reproduce — use the "
            "host pipeline (nThreads=N)")


class _Geom:
    """Uniform-geometry accumulator: every decoded frame must share one
    (H, W) after the loadSize resize, else the cache has no static shape."""

    def __init__(self):
        self.hw = None

    def check(self, img, path):
        if self.hw is None:
            self.hw = img.shape[:2]
        elif img.shape[:2] != self.hw:
            raise SystemExit(
                f"dataDevice requires uniform frame geometry after the "
                f"loadSize resize; {path} decodes to {img.shape[:2]} vs "
                f"{self.hw}")


def _require_fits(hw, fs, what="the crop"):
    h, w = hw
    if h < fs or w < fs:
        # The host samplers upscale undersized frames per sample; with a
        # uniform-geometry cache that would make EVERY sample a resize --
        # resize the corpus instead.
        raise SystemExit(
            f"dataDevice: frame geometry {(h, w)} is smaller than fineSize "
            f"{fs} — raise loadSize so {what} fits")


def _load_video_frames(opt: Opt, min_len: int):
    """Decode every eligible video's train-head frames for all variants.

    Returns (frames, meta_core): frames (n_variants, n_frames, H, W, nc)
    uint8 with every variant holding the same flattened frame list;
    meta_core = per-video offsets/counts into the flat list (counts are
    TRAIN-HEAD frame counts), variant cumprobs, hw.  Eligibility: the
    video's train head holds >= min_len frames (VideoCorpus.sample_clip's
    start-range rule for length=min_len)."""
    corpus_kw = {}
    if opt.vidExts:
        corpus_kw["suffixes"] = opt.vidExts.split(",")
        corpus_kw["counts"] = [int(c) for c in opt.vidCounts.split(",")]
    corpus = VideoCorpus(opt.DATA_ROOT,
                         variants=(("gt", 1.0 - opt.gt1Prob),
                                   ("gt1", opt.gt1Prob)),
                         split=opt.split, **corpus_kw)
    videos = [v for v in range(len(corpus.suffixes))
              if corpus.train_counts[v] >= min_len]
    if not videos:
        raise SystemExit(
            f"dataDevice: no video's train portion holds >= {min_len} "
            f"frames (split={opt.split}%)")
    variants = [name for name, _ in corpus.variants]
    probs = np.asarray([p for _, p in corpus.variants], np.float64)

    geom = _Geom()
    frames_per_variant = []
    for name in variants:
        decoded = []
        for v in videos:
            for i in range(corpus.train_counts[v]):
                path = corpus.get_clip(v, corpus.starts[v] + i, 1,
                                       variant=name)[0]
                img = decode.load_and_resize(path, opt.loadSize, opt.nc)
                geom.check(img, path)
                decoded.append(img)
        frames_per_variant.append(np.stack(decoded))
    frames = np.stack(frames_per_variant)   # (V, N, H, W, nc)

    offsets, counts, off = [], [], 0
    for v in videos:
        offsets.append(off)
        counts.append(corpus.train_counts[v])
        off += corpus.train_counts[v]
    meta = {"hw": geom.hw, "offsets": np.asarray(offsets, np.int32),
            "counts": np.asarray(counts, np.int32),
            "cumprobs": np.cumsum(probs).astype(np.float32)}
    return frames, meta


def _mask_at(opt: Opt, hw, nc: int) -> np.ndarray:
    """The global logo mask rescaled to frame geometry with the >=128
    binarization (datavid/donkey_folder.lua:109), broadcast to nc channels;
    zeros when no mask is configured (video regime without maskName)."""
    h, w = hw
    if not opt.maskName:
        return np.zeros((h, w, nc), np.uint8)
    m = _cached_mask_at(load_mask(opt.maskName), {}, h, w)
    return np.broadcast_to(m, (h, w, nc)).copy()


def load_corpus(opt: Opt, regime: str):
    """Decode the full train split to host numpy (the Python decode path).

    Returns ``(arrays, meta)``: ``arrays`` is a tuple of uint8 numpy arrays
    (regime-specific -- see each branch) for :func:`to_device`; ``meta``
    holds the static tables the sampler reads plus ``desc`` (a one-liner for
    the loop's startup print)."""
    check_regime(opt, regime)

    if regime == "center":
        # Uniform class -> uniform image (data/dataset.lua:351-364):
        # flatten classes with per-class offsets so the two-level draw
        # survives.
        index = FolderIndex(opt.DATA_ROOT, split=opt.split,
                            cache_dir=opt.cacheDir or None)
        classes = [c for c in index.classes if index.train_files[c]]
        if not classes:
            raise SystemExit("dataDevice: the train split is empty")
        geom = _Geom()
        decoded, offsets, counts = [], [], []
        for c in classes:
            offsets.append(len(decoded))
            counts.append(len(index.train_files[c]))
            for p in index.train_files[c]:
                img = decode.load_and_resize(p, opt.loadSize, opt.nc)
                geom.check(img, p)
                decoded.append(img)
        _require_fits(geom.hw, opt.fineSize)
        images = np.stack(decoded)
        meta = {"hw": geom.hw, "offsets": np.asarray(offsets, np.int32),
                "counts": np.asarray(counts, np.int32),
                "desc": f"{len(decoded)} images x {len(classes)} classes"}
        return (images,), meta

    if regime == "logo":
        # Paired masked/gt, train head of the sorted pair list
        # (PairedIndex.split); the host's per-pair size-equality assert is
        # subsumed by the uniform-geometry requirement.
        paired = PairedIndex(opt.DATA_ROOT, opt.DATA_ROOT_GT,
                             split=opt.split)
        if paired.n_train == 0:
            raise SystemExit("dataDevice: the train split is empty")
        geom = _Geom()
        ms, gs = [], []
        for pm, pg in zip(paired.masked[:paired.n_train],
                          paired.gt[:paired.n_train]):
            im = decode.load_and_resize(pm, opt.loadSize, opt.nc)
            ig = decode.load_and_resize(pg, opt.loadSize, opt.nc)
            geom.check(im, pm)
            geom.check(ig, pg)
            ms.append(im)
            gs.append(ig)
        _require_fits(geom.hw, opt.fineSize)
        meta = {"hw": geom.hw, "n": paired.n_train,
                "desc": f"{paired.n_train} masked/gt pairs"}
        return (np.stack(ms), np.stack(gs)), meta

    if regime in ("video", "video3d"):
        frames, meta = _load_video_frames(opt, min_len=opt.predLen)
        _require_fits(meta["hw"], opt.fineSize)
        meta["desc"] = (f"{frames.shape[1]} frames x {frames.shape[0]} "
                        f"variants ({meta['counts'].shape[0]} videos)")
        return (frames, _mask_at(opt, meta["hw"], 1)), meta

    # wholeim
    if not opt.maskName:
        raise SystemExit("wholeim regime requires maskName")
    frames, meta = _load_video_frames(opt, min_len=1)
    meta["desc"] = (f"{frames.shape[1]} frames x {frames.shape[0]} "
                    f"variants ({meta['counts'].shape[0]} videos)")
    return (frames, _mask_at(opt, meta["hw"], opt.nc)), meta


def to_device(arrays, device) -> tuple[torch.Tensor, ...]:
    """The corpus arrays as uint8 tensors on ``device``, copied once."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _uniform_index(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Uniform int in [0, count) for a per-item count: floor(u * count) in
    f32, capped at count - 1 (the JAX sampler's ``_uniform_index``)."""
    return torch.minimum((u * count.float()).long(), count.long() - 1)


def _span(start: torch.Tensor, size: int) -> torch.Tensor:
    """(n, size) indices start[i] + 0..size-1."""
    return start[:, None] + torch.arange(size, device=start.device)


def wholeim_transform(opt: Opt, frames: torch.Tensor, mask3: torch.Tensor,
                      fi: torch.Tensor, ch: torch.Tensor, cw: torch.Tensor,
                      flip: torch.Tensor, grid=None):
    """The wholeim donkey transform of frames ``frames[fi]`` ((N,H,W,nc)
    uint8, ``fi`` (n,)) with explicit decisions ch, cw (n,) int and flip
    (n,) bool: mask-fill -> translate -> flip -> patch slice, as one gather.

    Returns (masked patches (n,fs,fs,nc*arrh*arrw), target patches and
    their mask (n,fs,fs,nc*outh*outw), the dark-check mean (n,) f32 over the
    translated, flipped frame's top-left fs x fs).  ``grid``: the patch
    origins to slice (default: the arrh x arrw grid in (hi, wi) order); the
    sampler's dark check passes [(0, 0)] alone and reads only the mean."""
    fs, nc = opt.fineSize, opt.nc
    h, w = frames.shape[1:3]
    dev = frames.device
    arrh, arrw, outh, outw = opt.array_h, opt.array_w, opt.out_h, opt.out_w
    steph, stepw = (h - fs) // (arrh - 1), (w - fs) // (arrw - 1)
    if grid is None:
        grid = [(hi * steph, wi * stepw) for hi in range(arrh)
                for wi in range(arrw)]
    ar = torch.arange(fs, device=dev)
    ys = torch.tensor([y for y, _ in grid], device=dev)[:, None] + ar
    xs = torch.tensor([x for _, x in grid], device=dev)[:, None] + ar
    # final[Y, X] = frame[Y + ch - 1, X' + cw - 1], X' = w-1-X when flipped;
    # zero where the source falls outside (donkey_wholeim.lua:168-174).
    sy = ys[None] + (ch - 1).long()[:, None, None]               # (n,P,fs)
    xx = torch.where(flip[:, None, None], w - 1 - xs[None], xs[None])
    sx = xx + (cw - 1).long()[:, None, None]
    valid = ((sy < h)[..., :, None] & (sx < w)[..., None, :])[..., None]
    sy, sx = sy.clamp(max=h - 1), sx.clamp(max=w - 1)
    iy, ix = sy[..., :, None], sx[..., None, :]                  # (n,P,fs,1)
    img = frames[fi.long()[:, None, None, None], iy, ix]      # (n,P,fs,fs,nc)
    zero = torch.zeros((), dtype=img.dtype, device=dev)
    img = torch.where(valid, img, zero)
    dark = img[:, 0].sum(dim=(1, 2, 3), dtype=torch.float32) / (fs * fs * nc)
    if len(grid) == 1:
        return None, None, None, dark
    m = torch.where(valid, mask3[iy, ix], zero)
    fill = torch.tensor(int(round(opt.maskValue * 255.0)), dtype=img.dtype,
                        device=dev)
    masked = torch.where(m > 0, fill, img)
    out_ids = [hi * arrw + wi for hi in range(outh) for wi in range(outw)]

    def fold(p):   # (n,P,fs,fs,nc) -> (n,fs,fs,P*nc), patch-major channels
        return p.permute(0, 2, 3, 1, 4).reshape(p.shape[0], fs, fs, -1)

    return fold(masked), fold(img[:, out_ids]), fold(m[:, out_ids]), dark


class DeviceSampler:
    """``sampler(arrays, gen) -> batch``: one training batch of the regime,
    uint8 on the corpus's device, drawn from ``gen`` (a generator on that
    device).  ``arrays``: the :func:`to_device` tuple of ``load_corpus``'s
    arrays; ``meta``: its tables."""

    ATTEMPTS = 4   # candidates per pending sample and round (rejection)

    def __init__(self, opt: Opt, regime: str, meta, device):
        check_regime(opt, regime)
        self.opt, self.regime = opt, regime
        self.device = torch.device(device)
        self.hw = tuple(int(d) for d in meta["hw"])
        self.fs = opt.fineSize
        if regime == "wholeim":
            _require_fits(self.hw, self.fs, what="the patch grid")
        tables = {k: torch.as_tensor(meta[k], device=self.device)
                  for k in ("offsets", "counts", "cumprobs") if k in meta}
        self.tables = tables
        self.n_pairs = int(meta.get("n", 0))
        if regime in ("video", "video3d"):
            # clip starts per video: train-head frames minus the clip
            # length (VideoCorpus._start_range); > 0 was enforced at load
            tables["n_starts"] = tables["counts"] - (opt.predLen - 1)
        self.stats = {"batches": 0, "rounds": 0, "syncs": 0}

    # -- decisions ----------------------------------------------------------

    def _randint(self, gen, lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=self.device)

    def _rand(self, gen, n):
        return torch.rand(n, generator=gen, device=self.device)

    def _crop_yx(self, gen, n):
        """The host samplers' crop-offset rule (_random_crop_hw): uniform
        in [0, max(dim - fs, 1))."""
        h, w = self.hw
        return (self._randint(gen, 0, max(h - self.fs, 1), n),
                self._randint(gen, 0, max(w - self.fs, 1), n))

    def _video_frame(self, gen, n, counts):
        """(flat frame index variant * N + offsets[v] + f) of a uniform
        video, a uniform frame below ``counts[v]`` and a variant by
        cumulative probability (VideoCorpus.sample_clip's acc loop, the
        last variant the fallback)."""
        t = self.tables
        v = self._randint(gen, 0, t["counts"].shape[0], n)
        f = _uniform_index(self._rand(gen, n), counts[v])
        r = self._rand(gen, n)
        variant = torch.clamp(
            (r[:, None] >= t["cumprobs"][None]).sum(1),
            max=t["cumprobs"].shape[0] - 1)
        return variant, t["offsets"][v].long() + f

    def draws(self, gen: torch.Generator, n: int) -> dict:
        """``n`` candidates' decisions, (n,) tensors on the device:
        center {index, y, x}; logo {index, y, x}; video/video3d {variant,
        frame (the clip's first), y, x, u_dark}; wholeim {variant, frame,
        ch, cw, flip, u_dark}."""
        t = self.tables
        if self.regime == "center":
            c = self._randint(gen, 0, t["counts"].shape[0], n)
            i = _uniform_index(self._rand(gen, n), t["counts"][c])
            y, x = self._crop_yx(gen, n)
            return {"index": t["offsets"][c].long() + i, "y": y, "x": x}
        if self.regime == "logo":
            i = self._randint(gen, 0, self.n_pairs, n)
            y, x = self._crop_yx(gen, n)   # ONE crop for both halves
            return {"index": i, "y": y, "x": x}
        if self.regime in ("video", "video3d"):
            variant, frame = self._video_frame(gen, n, t["n_starts"])
            y, x = self._crop_yx(gen, n)
            return {"variant": variant, "frame": frame, "y": y, "x": x,
                    "u_dark": self._rand(gen, n)}
        variant, frame = self._video_frame(gen, n, t["counts"])
        return {"variant": variant, "frame": frame,
                "ch": self._randint(gen, 1, _TRANS_H + 1, n),
                "cw": self._randint(gen, 1, _TRANS_W + 1, n),
                "flip": self._rand(gen, n) > 0.6,         # hflip p=0.4
                "u_dark": self._rand(gen, n)}

    # -- gathers ------------------------------------------------------------

    def _crop(self, images, index, y, x):
        """images[index, y:y+fs, x:x+fs] per item: (n, fs, fs, C)."""
        rows, cols = _span(y, self.fs), _span(x, self.fs)
        return images[index[:, None, None], rows[:, :, None],
                      cols[:, None, :]]

    def _flat_frames(self, frames):
        return frames.reshape((-1,) + tuple(frames.shape[2:]))

    def gather(self, arrays, d: dict) -> dict:
        """The batch dict for explicit decisions ``d`` (as ``draws`` gives
        them), indexing the resident corpus."""
        fs, nc = self.fs, self.opt.nc
        if self.regime == "center":
            return {"raw": self._crop(arrays[0], d["index"], d["y"], d["x"])}
        if self.regime == "logo":
            return {"raw_masked": self._crop(arrays[0], d["index"], d["y"],
                                             d["x"]),
                    "raw_gt": self._crop(arrays[1], d["index"], d["y"],
                                         d["x"])}
        frames, mask = arrays
        flat = self._flat_frames(frames)
        fi = d["variant"].long() * frames.shape[1] + d["frame"]
        if self.regime in ("video", "video3d"):
            pl = self.opt.predLen
            rows, cols = _span(d["y"], fs), _span(d["x"], fs)
            clip = flat[_span(fi, pl)[:, :, None, None],
                        rows[:, None, :, None], cols[:, None, None, :]]
            # (n, pl, fs, fs, nc) -> frame-major channel fold, as the host's
            # np.concatenate(frames, axis=-1) (datavid/donkey_folder.lua:138)
            raw = clip.permute(0, 2, 3, 1, 4).reshape(-1, fs, fs, pl * nc)
            return {"raw": raw,
                    "mask": mask[rows[:, :, None], cols[:, None, :]]}
        mp, op, kp, _ = wholeim_transform(self.opt, flat, mask, fi, d["ch"],
                                          d["cw"], d["flip"])
        return {"raw_masked": mp, "raw_real": op, "mask": kp}

    def dark_mean(self, arrays, d: dict) -> torch.Tensor:
        """The dark check's f32 mean over each candidate's uint8 crop: the
        folded clip crop (video) or the translated frame's top-left patch
        (wholeim)."""
        if self.regime in ("video", "video3d"):
            raw = self.gather(arrays, d)["raw"]
            return raw.sum(dim=(1, 2, 3), dtype=torch.float32) / raw[0].numel()
        frames = arrays[0]
        fi = d["variant"].long() * frames.shape[1] + d["frame"]
        return wholeim_transform(self.opt, self._flat_frames(frames),
                                 arrays[1], fi, d["ch"], d["cw"], d["flip"],
                                 grid=[(0, 0)])[3]

    # -- sampling -----------------------------------------------------------

    def __call__(self, arrays, gen: torch.Generator) -> dict:
        b = self.opt.batchSize
        self.stats["batches"] += 1
        if self.regime in ("center", "logo"):
            self.stats["rounds"] += 1
            return self.gather(arrays, self.draws(gen, b))
        k = self.ATTEMPTS
        p_reject = _REJECT_P[self.regime]
        chosen = None
        pending = torch.arange(b, device=self.device)
        while pending.numel():
            n = pending.numel()
            d = self.draws(gen, n * k)
            reject = (self.dark_mean(arrays, d) < _DARK) & \
                (d["u_dark"] <= p_reject)
            accepted = ~reject.view(n, k)
            # first accepted candidate (argmax gives the first maximum)
            pick = torch.arange(n, device=self.device) * k + \
                accepted.int().argmax(1)
            if chosen is None:
                chosen = {key: v[pick] for key, v in d.items()}
            else:  # rows still rejected are overwritten by a later round
                for key, v in d.items():
                    chosen[key][pending] = v[pick]
            self.stats["rounds"] += 1
            self.stats["syncs"] += 1
            pending = pending[torch.nonzero(~accepted.any(1)).squeeze(1)]
        return self.gather(arrays, chosen)


class NullLoader:
    """DataLoader stand-in when batches are synthesized on the device: the
    train loop's pump/close calls become no-ops."""

    def get_batch(self):
        return None

    def close(self):
        pass
