"""Dataset indexing for the center regime: ``FolderIndex``, copied from
video_filler_tpu/data/index.py (that module's package pulls in jax on
import).  It replaces the reference's shell-out indexer
(data/dataset.lua:115-244): ``os.scandir`` plus a JSON cache keyed by the
root and a directory-tree mtime signature.

* classes = immediate subdirectories (or the root itself if it holds images),
* ``sample``: uniform class, then uniform image within it
  (data/dataset.lua:351-364),
* deterministic train/test split by percentage (data/dataset.lua:263-309).
"""

from __future__ import annotations

import json
import os

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
