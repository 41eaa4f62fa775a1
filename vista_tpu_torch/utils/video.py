"""Host-side media writers: videos, PNG frames, image grids (counterpart of
``vista_tpu/utils/video.py``).

Inputs are ``(t, h, w, 3)`` float arrays in [0, 1] (generated) or in
[-1, 1] (``real=True``), NHWC. They need numpy and the standard library
alone: PNG is written with ``zlib``, and a video with imageio where it
imports and has a backend for the file, else as an AVI, Motion-JPEG where
PIL imports, else uncompressed. Each writer returns the path it wrote.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import List, Optional

import numpy as np


def _to_uint8(frames: np.ndarray, real: bool = False) -> np.ndarray:
    frames = np.asarray(frames, dtype=np.float32)
    if real:
        frames = (frames + 1.0) / 2.0
    return (np.clip(frames, 0.0, 1.0) * 255.0).astype(np.uint8)


def encode_png(rgb: np.ndarray) -> bytes:
    """One ``(h, w, 3)`` uint8 image -> PNG bytes (8-bit RGB, no filter)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def _write(path: str, data: bytes) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _encode_jpeg(frame: np.ndarray, quality: int) -> Optional[bytes]:
    """One RGB frame -> JPEG bytes through PIL; None without PIL."""
    try:
        from PIL import Image
    except ImportError:
        return None
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _dib(frame: np.ndarray) -> bytes:
    """One RGB frame as an uncompressed 24-bit DIB: rows bottom-up in BGR,
    each padded to 4 bytes."""
    h, w, _ = frame.shape
    pad = (-w * 3) % 4
    rows = frame[::-1, :, ::-1].reshape(h, w * 3)
    if pad:
        rows = np.concatenate([rows, np.zeros((h, pad), np.uint8)], axis=1)
    return rows.tobytes()


def save_video_avi_mjpeg(path: str, frames: np.ndarray, fps: int = 10,
                         real: bool = False, quality: int = 90) -> str:
    """Write ``(t, h, w, 3)`` frames as an AVI: Motion-JPEG where PIL
    imports, else uncompressed 24-bit frames. A self-contained RIFF muxer."""
    data = _to_uint8(frames, real)
    n, h, w, _ = data.shape
    jpegs = [_encode_jpeg(f, quality) for f in data]
    if all(j is not None for j in jpegs):
        payloads, handler, compression, kind = jpegs, b"MJPG", b"MJPG", b"00dc"
    else:
        payloads, handler, compression, kind = (
            [_dib(f) for f in data], b"DIB ", b"\0\0\0\0", b"00db")
    max_size = max(len(p) for p in payloads)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack("<14I", 1_000_000 // fps, max_size * fps, 0,
                       0x10,  # AVIF_HASINDEX
                       n, 0, 1, max_size, w, h, 0, 0, 0, 0)
    strh = (b"vids" + handler + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0,
                                            1, fps, 0, n, max_size, 0xFFFFFFFF, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, compression,
                       (w * 3 + 3) // 4 * 4 * h, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi, index, offset = [], [], 4  # offsets count from the 'movi' fourcc
    for p in payloads:
        movi.append(chunk(kind, p))
        index.append(kind + struct.pack("<III", 0x10, offset, len(p)))
        offset += len(movi[-1])
    riff = (b"AVI " + hdrl + lst(b"movi", b"".join(movi))
            + chunk(b"idx1", b"".join(index)))
    return _write(path, b"RIFF" + struct.pack("<I", len(riff)) + riff)


def save_video_mp4(path: str, frames: np.ndarray, fps: int = 10, real: bool = False) -> str:
    """Write ``(t, h, w, 3)`` frames as a video at the reference's 10 fps:
    mp4 through imageio where it has a backend for it, else an AVI beside
    ``path`` (see :func:`save_video_avi_mjpeg`)."""
    avi_path = os.path.splitext(path)[0] + ".avi"
    try:
        import imageio
    except ImportError:
        return save_video_avi_mjpeg(avi_path, frames, fps=fps, real=real)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        with imageio.get_writer(path, fps=fps) as writer:
            for f in _to_uint8(frames, real):
                writer.append_data(f)
        return path
    except (ValueError, RuntimeError, OSError):  # no backend for mp4
        # the frames as given: the JAX package hands its AVI writer the uint8
        # frames, which it rescales as floats to 0 or 255
        return save_video_avi_mjpeg(avi_path, frames, fps=fps, real=real)


def save_frames_png(dirpath: str, frames: np.ndarray, prefix: str = "frame",
                    real: bool = False) -> List[str]:
    """One PNG per frame, ``{prefix}_{i:04d}.png``; returns their paths."""
    return [_write(os.path.join(dirpath, f"{prefix}_{i:04d}.png"), encode_png(f))
            for i, f in enumerate(_to_uint8(frames, real))]


def save_grid_png(path: str, frames: np.ndarray, nrow: Optional[int] = None,
                  real: bool = False, pad: int = 2) -> str:
    """Tile ``(n, h, w, 3)`` into a grid PNG, ``nrow`` frames a row."""
    data = _to_uint8(frames, real)
    n, h, w, c = data.shape
    nrow = nrow or int(np.ceil(np.sqrt(n)))
    ncol = int(np.ceil(n / nrow))
    grid = np.zeros((ncol * (h + pad) - pad, nrow * (w + pad) - pad, c), np.uint8)
    for i, f in enumerate(data):
        r, col = divmod(i, nrow)
        grid[r * (h + pad): r * (h + pad) + h, col * (w + pad): col * (w + pad) + w] = f
    return _write(path, encode_png(grid))
