"""Host-side image decode/preprocess with the reference's numerics
(ref dataset.py:37-73, inference.py:39-68):

- PIL open -> RGB -> numpy
- domain 'A' (edge side of pix2pix-style AB images): left 256px crop,
  invert (255.-x, promoting to float64 as the reference does), 3x3 ones
  dilation once (edge thickening), invert back
- domain 'B': right 256px crop; domain None: the whole image
- resize to (size, size) with bilinear interpolation (cv2's INTER_LINEAR)
- float32 / 255, HWC (NHWC once batched)

A failed decode follows the call site, as in the JAX package: the
trainer's ``read_images`` skips the file (ref dataset.py:44-46),
``load_image`` returns None (ref inference.py:66-68), and
``decode_image(..., on_error="random")`` gives a random image (the
reference DataLoader's fallback, ref dataset.py:258-261).

Selection for a uint8 image, as in the JAX package: cv2 when importable
(bit parity with the reference), else the native C++ pass
(``data/native.py``), else numpy (exact for
the dilation, float-exact bilinear for the resize). PIL and cv2 are
imported inside the functions that need them, so the array-level path
(``preprocess_array`` on a decoded array) runs on a host that has neither.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _dilate3x3(img: np.ndarray) -> np.ndarray:
    """3x3 ones-kernel dilation (a max filter) with cv2.dilate's border
    handling (max over the valid neighbours)."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.dilate(img, np.ones((3, 3), np.uint8), iterations=1)
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="constant",
                 constant_values=-np.inf)
    out = img.copy()
    h, w = img.shape[:2]
    for dy in range(3):
        for dx in range(3):
            np.maximum(out, pad[dy:dy + h, dx:dx + w], out)
    return out


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(..., (size, size)) with the default INTER_LINEAR."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (size, size))
    # Float bilinear with half-pixel centres (cv2's convention).
    h, w = img.shape[:2]
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = img.astype(np.float64)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def preprocess_array(image: np.ndarray, domain: Optional[str],
                     image_size: int) -> np.ndarray:
    """Domain crop/dilate + resize + normalize: HWC uint8/float in, HWC
    float32 in [0,1] out."""
    if isinstance(image, np.ndarray) and image.dtype == np.uint8:
        from . import native

        try:
            if _cv2() is None and native.available():
                return native.preprocess(image, domain, image_size)
        except Exception:  # noqa: BLE001 - the Python path decides, as in the JAX package
            pass
    if domain == "A":
        image = image[:, :256, :]
        image = 255.0 - image
        image = _dilate3x3(image)
        image = 255.0 - image
    elif domain == "B":
        image = image[:, 256:, :]
    image = _resize(image, image_size)
    return np.asarray(image, np.float32) / 255.0


def decode_image(path, domain: Optional[str] = None, image_size: int = 64,
                 on_error: str = "raise") -> Optional[np.ndarray]:
    """Decode one file to (H, W, 3) float32 in [0,1]. on_error: "raise",
    "none" (None, with a message) or "random" (a random image, with a
    message)."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            image = np.array(im.convert("RGB"))
        return preprocess_array(image, domain, image_size)
    except Exception as e:  # noqa: BLE001 - the reference's own catch-all
        if on_error == "raise":
            raise
        print(f"이미지 로딩 실패: {path}, 오류: {e}")
        if on_error == "random":
            return np.random.rand(image_size, image_size, 3).astype(np.float32)
        return None


def read_images(filenames: List[str], domain: Optional[str] = None,
                image_size: int = 64) -> np.ndarray:
    """Decode a list of files to NHWC, skipping the ones that fail (ref
    dataset.py:37-73)."""
    images = [img for img in (decode_image(fn, domain, image_size, on_error="none")
                              for fn in filenames) if img is not None]
    if not images:
        raise ValueError("유효한 이미지가 없습니다.")
    return np.stack(images)


def load_image(path, image_size: int = 64, domain: Optional[str] = None,
               dataset_type: Optional[str] = None) -> Optional[np.ndarray]:
    """Decode one file to (H, W, 3) float32 in [0,1] (ref inference.py:
    39-68): the domain crop applies only to the edges2* dataset types, and
    a file that cannot be read gives None, with a message."""
    if dataset_type not in ("edges2handbags", "edges2shoes"):
        domain = None
    return decode_image(path, domain, image_size, on_error="none")


def shuffle_data(da, db) -> Tuple[np.ndarray, np.ndarray]:
    """Independent per-domain shuffles from numpy's global state: unpaired
    training (ref dataset.py:24-35). The trainer's loader draws its orders
    from (seed, epoch) instead (``data/pipeline.py``)."""
    a_idx = np.arange(len(da))
    np.random.shuffle(a_idx)
    b_idx = np.arange(len(db))
    np.random.shuffle(b_idx)
    return np.array(da)[a_idx], np.array(db)[b_idx]
