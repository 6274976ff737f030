"""ctypes bindings for the native C++ loader (csrc/vf_native.cpp), copied
from video_filler_tpu/data/native.py (the port imports nothing of the JAX
package).

The native library does parallel JPEG/PNG decode + short-side resize + a
shared per-clip random crop with the GIL released -- the donkey-pool +
`image` C-lib role (data/data.lua:26-60, data/donkey_folder.lua:39-62).
data/pipeline.py uses it where it builds; the Python decode stays the
reference and the per-image fallback.

``g++`` builds it at first use into
``build/video_filler_tpu_torch/libvf_native-<hash>.so`` at the repository
root (never into ``native/``, the JAX package's).  The hash covers the
source, the flags and the host's CPU (``host_tag``): the library is built
with ``-march=native``, and a checkout that moves to another machine must
not load a library that can SIGILL there.  It compiles to a temporary name
and renames, so concurrent builds never load a half-written file.  A
failed build is not silent: ``available()`` is False and
``unavailable_reason()`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from video_filler_tpu_torch.ops.cuda.build import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "vf_native.cpp")
# The flags and libraries of native/build.sh.
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lib = None
_lock = threading.Lock()
_error: str | None = None


def host_tag() -> str:
    """CPU fingerprint: model name + flags from /proc/cpuinfo (stable across
    boots, distinct across machine types); copied from
    video_filler_tpu/utils/cache.py."""
    try:
        with open("/proc/cpuinfo") as f:
            ident = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return hashlib.sha1(
            "".join(sorted(set(ident))).encode()).hexdigest()[:12]
    except OSError:
        return "default"


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            GXX_FLAGS + LIBS + (host_tag(),)).encode())
    return os.path.join(BUILD_DIR,
                        f"libvf_native-{digest.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode})"
                           f": {proc.stderr.strip()[-2000:]}")
    os.replace(tmp, so)


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        so = library_path()
        try:
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.vf_load_clips.restype = ctypes.c_int
        lib.vf_load_clips.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.vf_image_size.restype = ctypes.c_int
        lib.vf_image_size.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.vf_load_frames.restype = ctypes.c_int
        lib.vf_load_frames.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why the library could not be built or loaded; None when it loads."""
    _load()
    return _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"vf_native is unavailable: {_error}")
    return lib


def image_size(path: str) -> tuple[int, int]:
    lib = _require()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.vf_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)):
        raise IOError(f"native decode failed for {path}")
    return h.value, w.value


def load_clips(clip_paths: list[list[str]], load_size: int, crop: int,
               seeds: np.ndarray, n_threads: int = 0
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """Decode clips in parallel with one shared random crop per clip.

    Returns (batch (n, crop, crop, frames*3) uint8,
             offsets (n, 4) int32 [y, x, resized_h, resized_w],
             n_failures).
    """
    lib = _require()
    n = len(clip_paths)
    if n == 0:
        return (np.empty((0, crop, crop, 0), np.uint8),
                np.zeros((0, 4), np.int32), 0)
    frames = len(clip_paths[0])
    # The C side indexes paths[ci*frames + fi]: a ragged clip list would
    # read past the ctypes array (garbage pointers into fopen), and an
    # empty clip hits imgs[0] on an empty vector -- both UB, reject here.
    if frames == 0 or any(len(c) != frames for c in clip_paths):
        raise ValueError(
            "load_clips needs equal-length, non-empty clips; got lengths "
            f"{sorted({len(c) for c in clip_paths})}")
    flat = [p.encode() for clip in clip_paths for p in clip]
    arr = (ctypes.c_char_p * len(flat))(*flat)
    out = np.empty((n, crop, crop, frames * 3), np.uint8)
    offsets = np.zeros((n, 4), np.int32)
    seeds = np.ascontiguousarray(seeds, np.uint64)
    fails = lib.vf_load_clips(
        arr, n, frames, load_size, crop,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    return out, offsets, fails


def load_frames(paths: list[str], load_size: int, max_h: int, max_w: int,
                n_threads: int = 0, out: np.ndarray | None = None
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Decode + short-side-resize full frames in parallel (no crop) -- the
    wholeim/logo donkeys' heavy per-sample work.

    Returns (buf (n, max_h, max_w, 3) uint8 -- frame i occupies
             buf[i, :h, :w]; hw (n, 2) int32 [h, w], (0, 0) = this frame
             failed (decode error / exceeds the slot); n_failures).
    ``out``: caller-owned slot buffer to reuse across batches (its first n
    slots are used)."""
    lib = _require()
    n = len(paths)
    flat = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * n)(*flat)
    if out is not None and out.shape[0] >= n \
            and out.shape[1:] == (max_h, max_w, 3) \
            and out.dtype == np.uint8 and out.flags.c_contiguous:
        buf = out[:n]
    else:
        buf = np.empty((n, max_h, max_w, 3), np.uint8)
    hw = np.zeros((n, 2), np.int32)
    fails = lib.vf_load_frames(
        arr, n, load_size, max_h, max_w,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    return buf, hw, fails
