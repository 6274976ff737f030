"""Host-side image decode + variable-shape resize, copied from
video_filler_tpu/data/decode.py (that module's package pulls in jax on
import).

Replaces the Torch ``image`` C library calls in the donkeys
(data/donkey_folder.lua:39-62): JPEG/PNG decode and the aspect-preserving
short-side resize (variable output shapes must stay on the host; everything
static-shaped moves on device — ops/image.py).

cv2 (SIMD decode+resize) with a PIL fallback.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False
from PIL import Image


def decode_image(path: str, nc: int = 3) -> np.ndarray:
    """Decode to uint8 HWC RGB (or single-channel for nc=1)."""
    if _HAS_CV2:
        flag = cv2.IMREAD_COLOR if nc == 3 else cv2.IMREAD_GRAYSCALE
        img = cv2.imread(path, flag)
        if img is None:
            raise IOError(f"failed to decode {path}")
        if nc == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        else:
            img = img[..., None]
        return img
    try:
        img = Image.open(path)
        img = img.convert("RGB" if nc == 3 else "L")
    except Exception as e:
        # Same error contract as the cv2 branch: an IOError naming the file
        # (PIL's UnidentifiedImageError message doesn't say "decode").
        raise IOError(f"failed to decode {path}") from e
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize to (height, width)."""
    if _HAS_CV2:
        out = cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)
        return out[..., None] if out.ndim == 2 else out
    pil = Image.fromarray(img.squeeze(-1) if img.shape[-1] == 1 else img)
    out = np.asarray(pil.resize((width, height), Image.BILINEAR), np.uint8)
    return out[..., None] if out.ndim == 2 else out


def short_side_resize(img: np.ndarray, load_size: int,
                      rs: np.random.RandomState | None = None) -> np.ndarray:
    """The donkey's loadSize semantics (data/donkey_folder.lua:43-62):

    load_size > 0: resize so the SHORT side == load_size (aspect preserved);
    load_size == 0: no resize;
    load_size == -1: random uniform scale in [0.5, 1.5];
    load_size < -1: random uniform scale in [1, 3].

    NOT replicated: the reference's random-scale branch calls
    ``image.scale(input, iH, iW)`` (donkey_folder.lua:59) with the
    width/height arguments swapped, transposing the target dims and
    distorting aspect on non-square images — a latent defect; here both
    dims scale by the same factor, the obvious intent.
    """
    h, w = img.shape[:2]
    if load_size > 0:
        # Half-up rounding, matching the native pool's short_side_dims
        # (native/vf_native.cpp) so a Python-fallback frame lands on the
        # same target size as its natively-decoded neighbors; banker's
        # round() here made mixed-decoder logo pairs differ by one pixel
        # at *.5 aspect ratios.
        if w < h:
            nw, nh = load_size, max(1, int(0.5 + load_size * h / w))
        else:
            nh, nw = load_size, max(1, int(0.5 + load_size * w / h))
        if (nh, nw) == (h, w):
            return img
        return resize(img, nh, nw)
    if load_size == 0:
        return img
    rs = rs or np.random
    lo, hi = (0.5, 1.5) if load_size == -1 else (1.0, 3.0)
    s = rs.uniform(lo, hi)
    return resize(img, max(1, round(h * s)), max(1, round(w * s)))


def load_and_resize(path: str, load_size: int, nc: int = 3,
                    rs: np.random.RandomState | None = None) -> np.ndarray:
    return short_side_resize(decode_image(path, nc), load_size, rs)
