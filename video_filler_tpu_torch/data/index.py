"""Dataset indexing: ``FolderIndex``, ``PairedIndex`` and ``VideoCorpus``,
copied from video_filler_tpu/data/index.py (that module's package pulls in
jax on import).  It replaces the reference's shell-out indexer
(data/dataset.lua:115-244): ``os.scandir`` plus a JSON cache keyed by the
root and a directory-tree mtime signature.

* classes = immediate subdirectories (or the root itself if it holds images),
* ``sample``: uniform class, then uniform image within it
  (data/dataset.lua:351-364),
* deterministic train/test split by percentage (data/dataset.lua:263-309),
* paired variant: same index in two parallel folders
  (data/dataset_logo.lua:354-391),
* video corpus: numbered frames per video, discovered by scanning, sampled
  as in datavid/dataset.lua:341-378.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")


def _cache_path(root: str, tag: str, cache_dir: str | None = None) -> str:
    """Index-cache location: co-located with the data by default
    (``<root>/cache/``), overridable via ``cache_dir`` (Opt.cacheDir).

    The reference writes ``cache/<mangled DATA_ROOT>_trainCache.t7`` relative
    to the CWD (data/donkey_folder.lua:29-32) — which scatters ``cache/``
    dirs wherever the CLI happens to run and litters the repo from pytest
    tmp corpora.  Keying off the dataset root keeps the cache next to the
    thing it indexes (and tmp-corpus caches die with the tmp dir).  The dir
    is dot-prefixed because scanning skips hidden entries — the cache must
    not register as a class subdir or perturb the mtime signature."""
    if cache_dir is None:
        return os.path.join(root, ".index_cache", f"{tag}.json")
    mangled = root.strip("/").replace("/", "_")
    return os.path.join(cache_dir, f"{mangled}_{tag}.json")


def _tree_signature(root: str) -> list:
    """mtimes of root and every descendant DIRECTORY.  Adding/removing/
    renaming a file touches its parent directory's mtime, so this detects
    corpus edits at any depth; the root's mtime alone misses changes inside
    class subdirectories (only direct children touch it).  Stats directories
    only — far cheaper than rescanning the files."""
    sig = [[".", os.path.getmtime(root)]]
    for dirpath, dirnames, _ in os.walk(root):
        # Hidden dirs (e.g. the co-located .index_cache) are not data:
        # including them would invalidate the signature on every cache write.
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("."))
        for d in dirnames:
            p = os.path.join(dirpath, d)
            sig.append([os.path.relpath(p, root), os.path.getmtime(p)])
    return sig


def _scan_images(d: str) -> list[str]:
    out = []
    for entry in sorted(os.scandir(d), key=lambda e: e.name):
        if entry.name.startswith("."):
            continue  # hidden entries (e.g. .index_cache) are not data
        if entry.is_file() and entry.name.lower().endswith(IMG_EXTS):
            out.append(entry.path)
        elif entry.is_dir():
            out.extend(_scan_images(entry.path))
    return out


class FolderIndex:
    """Class-folder image index with JSON caching."""

    def __init__(self, root: str, split: int = 100,
                 cache_dir: str | None = None):
        self.root = root
        self.classes: list[str] = []
        self.class_files: dict[str, list[str]] = {}
        cache = _cache_path(root, "index", cache_dir)
        if os.path.exists(cache):
            try:
                with open(cache) as f:
                    data = json.load(f)
            except (json.JSONDecodeError, OSError):
                data = {}  # concurrent writer / corrupt cache: rescan below
            if data.get("signature") == _tree_signature(root):
                self.classes = data["classes"]
                self.class_files = data["files"]
        if not self.classes:
            subdirs = [e.name for e in sorted(os.scandir(root),
                                              key=lambda e: e.name)
                       if e.is_dir() and not e.name.startswith(".")]
            if subdirs:
                self.classes = subdirs
                self.class_files = {c: _scan_images(os.path.join(root, c))
                                    for c in subdirs}
            else:
                self.classes = ["."]
                self.class_files = {".": _scan_images(root)}
            self.class_files = {c: f for c, f in self.class_files.items() if f}
            self.classes = [c for c in self.classes if c in self.class_files]
            try:
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                # Atomic write: concurrent processes share the cache dir,
                # so a reader must never see a half-written file.
                tmp = f"{cache}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"signature": _tree_signature(root),
                               "classes": self.classes,
                               "files": self.class_files}, f)
                os.replace(tmp, cache)
            except OSError:
                # Read-only dataset root (default cache location is inside
                # it): the cache is an optimization — scan-only beats
                # refusing to train.  Point cacheDir= somewhere writable to
                # cache anyway.
                pass
        if not self.classes:
            raise FileNotFoundError(f"no images under {root}")
        # train/test split per class, in file order (data/dataset.lua:263-309)
        self.train_files: dict[str, list[str]] = {}
        self.test_files: dict[str, list[str]] = {}
        for c, files in self.class_files.items():
            n_train = int(round(len(files) * split / 100.0))
            self.train_files[c] = files[:n_train]
            self.test_files[c] = files[n_train:]

    def size(self, split: str = "train") -> int:
        files = self.train_files if split == "train" else self.test_files
        return sum(len(v) for v in files.values())

    def sample(self, rs: np.random.RandomState, n: int,
               split: str = "train") -> list[str]:
        """Uniform class then uniform image (data/dataset.lua:351-364)."""
        files = self.train_files if split == "train" else self.test_files
        classes = [c for c in self.classes if files[c]]
        if not classes:
            raise ValueError(
                f"the {split!r} split is empty — construct the index with "
                "split < 100 to reserve held-out data (dataset.lua:48)")
        out = []
        for _ in range(n):
            c = classes[rs.randint(len(classes))]
            out.append(files[c][rs.randint(len(files[c]))])
        return out


class PairedIndex:
    """Two parallel folders (masked, gt) sampled at the same index
    (data/dataset_logo.lua:354-391: class 1 = gt, class 2 = masked).

    ``split`` reserves a held-out contiguous TAIL of the (sorted) pair list,
    same convention as VideoCorpus.  This diverges from the reference ON
    PURPOSE: its ``getTwoImages`` ignores the split lists the base dataset
    builds (dataset_logo.lua:354-365 indexes imagePath directly), so the
    reference's logo regime can never report held-out metrics; here every
    regime is held to the same evidence bar (split=100 reproduces the
    reference's split-blind behavior exactly)."""

    def __init__(self, masked_root: str, gt_root: str, split: int = 100):
        self.masked = _scan_images(masked_root)
        self.gt = _scan_images(gt_root)
        if len(self.masked) != len(self.gt):
            raise ValueError(
                f"paired folders differ in size: {len(self.masked)} masked vs "
                f"{len(self.gt)} gt (dataset_logo.lua:358 asserts equality)")
        if not self.masked:
            raise FileNotFoundError(f"no images under {masked_root}")
        if not 0 < split <= 100:
            raise ValueError(f"split must be in (0, 100], got {split}")
        self.n_train = int(round(len(self.masked) * split / 100.0))

    def size(self, split: str = "train") -> int:
        if split == "train":
            return self.n_train
        return len(self.masked) - self.n_train

    def sample(self, rs: np.random.RandomState, n: int,
               split: str = "train") -> list[tuple[str, str]]:
        if split == "train":
            lo, hi = 0, self.n_train
        else:
            lo, hi = self.n_train, len(self.masked)
        if hi <= lo:
            raise ValueError(
                f"the {split!r} split is empty — construct PairedIndex with "
                "split < 100 to reserve held-out pairs")
        idx = lo + rs.randint(hi - lo, size=n)
        return [(self.masked[i], self.gt[i]) for i in idx]


@dataclass
class VideoCorpus:
    """Config-driven video-frame corpus.

    Layout (generalizing datavid/dataset.lua:360-378): ``root/<variant>/``
    holds frames named ``<%0Nd><suffix>`` per video, where each suffix
    identifies one video.  ``variants`` are alternative ground-truth dirs
    sampled by probability (the reference's gt/ 0.6 vs gt1/ 0.4).

    ``split`` reserves a held-out TAIL frame range per video: the first
    ``round(count * split/100)`` frames of each video are the train portion,
    the remainder the test portion.  This brings the folder dataset's
    percentage split (data/dataset.lua:263-309 — machinery the reference
    built but never wired to video) to the video corpora, as contiguous
    tail ranges rather than a random permutation so adjacent near-duplicate
    frames cannot straddle the boundary en masse.
    """

    root: str
    variants: tuple[tuple[str, float], ...] = (("gt", 0.6), ("gt1", 0.4))
    suffixes: list[str] = field(default_factory=list)   # per-video suffixes
    counts: list[int] = field(default_factory=list)     # per-video frame count
    pad: int = 7                                        # zero-pad width
    start: int = 1                                      # first frame number
                                                        # (min over videos)
    starts: list[int] = field(default_factory=list)     # per-video first
                                                        # frame; defaults to
                                                        # `start` everywhere
    split: int = 100                                    # train percentage;
                                                        # tail frames are test
    _eligible_cache: dict = field(default_factory=dict, repr=False,
                                  compare=False)        # (length, split) ->
                                                        # eligible video ids

    def __post_init__(self):
        if not self.suffixes:
            self._discover()
        if len(self.suffixes) != len(self.counts):
            raise ValueError("suffixes and counts must align")
        if not self.starts:
            self.starts = [self.start] * len(self.suffixes)
        if len(self.starts) != len(self.suffixes):
            raise ValueError("starts and suffixes must align")
        if not 0 < self.split <= 100:
            raise ValueError(f"split must be in (0, 100], got {self.split}")
        self.train_counts = [int(round(c * self.split / 100.0))
                             for c in self.counts]

    def _discover(self) -> None:
        """Scan the first variant dir, group frames by suffix."""
        d = os.path.join(self.root, self.variants[0][0])
        pat = re.compile(r"^(\d+)(.*)$")
        groups: dict[str, list[int]] = {}
        pads: set[int] = set()
        for entry in os.scandir(d):
            if not entry.is_file():
                continue
            m = pat.match(entry.name)
            if m:
                groups.setdefault(m.group(2), []).append(int(m.group(1)))
                pads.add(len(m.group(1)))
        if not groups:
            raise FileNotFoundError(f"no numbered frames under {d}")
        self.suffixes = sorted(groups)
        self.counts = [max(groups[s]) - min(groups[s]) + 1
                       for s in self.suffixes]
        # Per-video first frame: videos may start at different numbers; a
        # single global minimum would build paths to nonexistent frames for
        # any video starting later.
        self.starts = [min(groups[s]) for s in self.suffixes]
        self.start = min(self.starts)
        if len(pads) != 1:
            raise ValueError(
                f"inconsistent frame-number zero-padding under {d}: {pads}")
        self.pad = pads.pop()

    def size(self, split: str = "train") -> int:
        if split == "train":
            return sum(self.train_counts)
        return sum(c - t for c, t in zip(self.counts, self.train_counts))

    def _start_range(self, v: int, length: int, split: str) -> tuple[int, int]:
        """(first_start, n_starts) of the clip-start range for one video's
        split portion; n_starts <= 0 means the portion can't fit a clip."""
        if split == "train":
            return self.starts[v], self.train_counts[v] - length + 1
        first = self.starts[v] + self.train_counts[v]
        return first, (self.counts[v] - self.train_counts[v]) - length + 1

    def sample_clip(self, rs: np.random.RandomState, length: int,
                    split: str = "train") -> list[str]:
        """Uniform video, uniform start, variant by probability
        (datavid/dataset.lua:360-378).  `split` confines the start range to
        the train head / held-out tail of each video."""
        # Counts/starts/split are immutable after __post_init__, so the
        # eligible-video list is memoized per (length, split) — sample_clip
        # runs per batch item per redraw, and rebuilding the list was an
        # O(n_videos) scan each time.
        videos = self._eligible_cache.get((length, split))
        if videos is None:
            videos = [v for v in range(len(self.suffixes))
                      if self._start_range(v, length, split)[1] > 0]
            self._eligible_cache[(length, split)] = videos
        if not videos:
            raise ValueError(
                f"no video has a {split!r} portion of >= {length} frames "
                f"(split={self.split}%) — lower `length` or adjust split")
        v = videos[rs.randint(len(videos))]
        first, n_starts = self._start_range(v, length, split)
        start = first + rs.randint(n_starts)
        r, acc = rs.rand(), 0.0
        variant = self.variants[-1][0]
        for name, p in self.variants:
            acc += p
            if r < acc:
                variant = name
                break
        return self.get_clip(v, start, length, variant)

    def get_clip(self, video: int, start: int, length: int,
                 variant: str | None = None) -> list[str]:
        """Paths of ``length`` consecutive frames of ``video`` from frame
        number ``start`` (the first variant unless one is named)."""
        variant = variant or self.variants[0][0]
        return [os.path.join(self.root, variant,
                             f"{start + i:0{self.pad}d}{self.suffixes[video]}")
                for i in range(length)]
