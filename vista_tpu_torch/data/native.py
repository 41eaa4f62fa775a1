"""ctypes binding of the native host input library (counterpart of
``vista_tpu/data/native.py``).

Loads ``native/libvista_host.so`` (built by ``make -C native``; the
``VISTA_HOST_LIB`` environment variable names another file): threaded JPEG
decode, center crop, Lanczos3 resize and [-1, 1] normalisation, off the
GIL. This is host decoding, not a device kernel. Callers check
:func:`available` and take the PIL path when the library is absent
(``datasets.center_crop_resize``); a library that loads and then fails to
decode raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", "libvista_host.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get("VISTA_HOST_LIB", _lib_path())
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.vh_process_jpeg_batch.restype = ctypes.c_int
    lib.vh_process_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.vh_crop_resize_normalize.restype = None
    lib.vh_crop_resize_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    if hasattr(lib, "vh_encode_jpeg"):  # older builds of the .so lack it
        lib.vh_encode_jpeg.restype = ctypes.c_long
        lib.vh_encode_jpeg.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def encode_jpeg_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "vh_encode_jpeg")


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """8-bit HWC RGB -> JPEG bytes (libjpeg, off the GIL)."""
    lib = _load()
    assert lib is not None and hasattr(lib, "vh_encode_jpeg")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    cap = w * h * 3 + 65536
    out = np.empty((cap,), np.uint8)
    size = lib.vh_encode_jpeg(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, quality,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if size < 0:
        raise IOError("JPEG encode failed")
    return out[:size].tobytes()


def crop_resize_normalize(rgb: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """8-bit HWC RGB -> float32 ``(target_h, target_w, 3)`` in [-1, 1]."""
    lib = _load()
    assert lib is not None, "native library not built (make -C native)"
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    sh, sw = rgb.shape[:2]
    out = np.empty((target_h, target_w, 3), np.float32)
    lib.vh_crop_resize_normalize(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), sw, sh,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), target_w, target_h)
    return out


def process_jpeg_batch(jpeg_bytes: List[bytes], target_h: int, target_w: int,
                       threads: int = 8) -> np.ndarray:
    """Decode and preprocess n JPEGs -> ``(n, target_h, target_w, 3)`` float32
    in [-1, 1]."""
    lib = _load()
    assert lib is not None, "native library not built (make -C native)"
    n = len(jpeg_bytes)
    bufs = (ctypes.c_char_p * n)(*jpeg_bytes)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in jpeg_bytes])
    out = np.empty((n, target_h, target_w, 3), np.float32)
    rc = lib.vh_process_jpeg_batch(
        bufs, lens, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        target_w, target_h, threads)
    if rc != 0:
        raise IOError(f"JPEG decode failed for frame {rc - 1}")
    return out


def load_frame_batch(paths: List[str], target_h: int, target_w: int,
                     threads: int = 8) -> np.ndarray:
    """Read JPEG files from disk and preprocess them (the native path)."""
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return process_jpeg_batch(blobs, target_h, target_w, threads)
