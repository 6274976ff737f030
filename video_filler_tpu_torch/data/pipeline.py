"""Host data pipeline for the center regime: the batch sampler and the
threaded prefetch pump, copied from video_filler_tpu/data/pipeline.py (that
module's package pulls in jax on import).  Python decode path only; the
native C++ decode comes later (ROADMAP A.1).

Samplers return uint8 numpy batches; flip, normalisation and the center
hole run on the device (train/step.py ``make_preprocess``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np

from video_filler_tpu_torch.config import Opt
from video_filler_tpu_torch.data import decode
from video_filler_tpu_torch.data.index import FolderIndex

Batch = dict[str, np.ndarray]


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
    (data/donkey_folder.lua:70-88).  `split` selects the folder dataset's
    train/test portion."""
    fs = opt.fineSize

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
        out = np.empty((opt.batchSize, fs, fs, opt.nc), np.uint8)
        for i, p in enumerate(paths):
            out[i] = _python_one(rs, p)
        return {"raw": out}

    return sample


def make_sampler(opt: Opt, regime: str, split: str = "train"):
    """(sampler, dataset_size) for a regime; center only."""
    if regime != "center":
        raise NotImplementedError(
            f"the {regime!r} sampler is not ported yet (ROADMAP A.7)")
    index = FolderIndex(opt.DATA_ROOT, split=opt.split,
                        cache_dir=opt.cacheDir or None)
    return center_sampler(opt, index, split=split), index.size(split)


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
