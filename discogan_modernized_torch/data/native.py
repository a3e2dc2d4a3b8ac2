"""ctypes bindings for the port's native preprocessing library
(``native/discodata.cpp``, its own copy of the JAX package's).

Built at first use with ``g++ -O3 -march=native`` into
``build/native/`` under the repository root (gitignored, beside the CUDA
kernels' ``build/torch_kernels/``), named by the hash of the source, so a
changed source builds anew and concurrent builds race safely. The
binary is never committed: ``-march=native`` makes it specific to the
host's instruction set. The fused ``preprocess_u8`` replaces the
reference's PIL -> numpy -> cv2 chain (crop, invert + dilate + invert,
resize, /255: ref dataset.py:52-66) with one C++ pass.

Selection in ``data/preprocess.py``: cv2 when importable (the reference's
own numerics), else this library, else numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "discodata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib = None
_DOMAIN_CODES = {None: 0, "A": 1, "B": 2}


def _build() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"discodata-{digest}.so"
    if lib.exists():
        return lib
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"native build failed: {e.stderr}") from e
    except FileNotFoundError as e:
        raise RuntimeError("g++ is not available for the native build") from e
    os.replace(tmp, lib)
    return lib


def load():
    """Load (building if needed) the library; raises on failure. A failure
    is remembered, so a host without a compiler does not retry the build
    for every image."""
    global _lib
    if _lib is False:
        raise RuntimeError("the native build failed earlier in this process")
    if _lib is None:
        try:
            lib = ctypes.CDLL(str(_build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.erode3x3_f32.argtypes = [f32p, f32p] + [ctypes.c_int] * 3
            lib.dilate3x3_f32.argtypes = [f32p, f32p] + [ctypes.c_int] * 3
            lib.resize_bilinear_f32.argtypes = [f32p, f32p] + [ctypes.c_int] * 5
            lib.preprocess_u8.argtypes = [u8p] + [ctypes.c_int] * 5 + [f32p]
        except Exception as e:
            _lib = False
            raise RuntimeError(f"native build/load failed: {e}") from e
        _lib = lib
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def erode3x3(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    out = np.empty_like(img)
    h, w, c = img.shape
    load().erode3x3_f32(_f32p(img), _f32p(out), h, w, c)
    return out


def dilate3x3(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    out = np.empty_like(img)
    h, w, c = img.shape
    load().dilate3x3_f32(_f32p(img), _f32p(out), h, w, c)
    return out


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    ih, iw, c = img.shape
    out = np.empty((size, size, c), np.float32)
    load().resize_bilinear_f32(_f32p(img), _f32p(out), ih, iw, size, size, c)
    return out


def preprocess(image_u8: np.ndarray, domain, size: int) -> np.ndarray:
    """Fused crop/edge/resize/normalize of one uint8 HWC image."""
    image_u8 = np.ascontiguousarray(image_u8, np.uint8)
    h, w, c = image_u8.shape
    if _DOMAIN_CODES[domain] == 2 and w <= 256:
        # The B-domain right crop of an image at most 256 wide is empty; the
        # cv2 path raises there too, and so decode_image's failure handling
        # stays the same on both paths.
        raise ValueError(f"domain 'B' crop is empty for width {w} <= 256")
    out = np.empty((size, size, c), np.float32)
    load().preprocess_u8(
        image_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c, _DOMAIN_CODES[domain], size, _f32p(out))
    return out
