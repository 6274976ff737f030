"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/video_filler_tpu_torch/lib<name>-<hash>.so`` at the repository root,
at first use.  The hash covers the source and the flags, so an edited source
rebuilds and a stale library is never loaded.  Compiling to a temporary name
and renaming keeps concurrent builders from loading a half-written file.

Nothing here runs at import: the CPU-only test machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "video_filler_tpu_torch")
# sm_90a: the Hopper target (wgmma/setmaxnreg exist only there).  -Xptxas -v
# reports registers, shared memory and spills per kernel in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                           "CUDA_HOME to build the port's kernels")
    return found


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless its current build exists.

    Returns (library path, nvcc's diagnostic output; "" when it was built
    before).  Raises RuntimeError with nvcc's output if compilation fails."""
    so = library_path(name)
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so, proc.stdout + proc.stderr


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(build(name)[0])
