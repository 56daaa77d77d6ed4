"""Image output: BMP (the reference's format) and PNG, with no dependency
beyond numpy and the standard library.

The reference writes 24-bit BMPs via CImg (``save_bmp``,
simple_raytracer.cpp:488-494) to ``images/generation/output{angle}.bmp``.
:func:`write_bmp` writes the same bytes as the JAX package's
(BITMAPINFOHEADER, bottom-up BGR rows, 4-byte row padding);
:func:`write_png` encodes an 8-bit RGB PNG with ``zlib`` and ``struct``
(the JAX package's goes through PIL).  :func:`read_bmp` reads a 24-bit
BMP back.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _host(img) -> np.ndarray:
    """[H, W, 3] uint8 as a host array (a tensor on any device, or an
    array)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.uint8)


def write_bmp(path: str, img) -> None:
    """Write [H, W, 3] uint8 RGB as a 24-bit BMP."""
    img = _host(img)
    h, w = img.shape[:2]
    row_size = (3 * w + 3) & ~3
    pad = row_size - 3 * w
    data_size = row_size * h
    header = struct.pack(
        "<2sIHHI", b"BM", 14 + 40 + data_size, 0, 0, 14 + 40)
    info = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size, 2835, 2835, 0, 0)
    bgr = img[::-1, :, ::-1]                 # bottom-up rows, BGR
    if pad:
        rows = np.zeros((h, row_size), np.uint8)
        rows[:, :3 * w] = bgr.reshape(h, 3 * w)
    else:
        rows = bgr.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(header)
        f.write(info)
        f.write(np.ascontiguousarray(rows).tobytes())


def read_bmp(path: str) -> np.ndarray:
    """A 24-bit uncompressed BMP (bottom-up or top-down rows) -> [H, W, 3]
    uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _, _, _, offset = struct.unpack_from("<2sIHHI", data, 0)
    _, w, h, _, bpp, comp = struct.unpack_from("<IiiHHI", data, 14)
    if magic != b"BM" or bpp != 24 or comp != 0:
        raise ValueError(f"{path}: not a 24-bit uncompressed BMP")
    row_size = (3 * w + 3) & ~3
    rows = np.frombuffer(data, np.uint8, row_size * abs(h), offset)
    img = rows.reshape(abs(h), row_size)[:, :3 * w].reshape(abs(h), w, 3)
    if h > 0:
        img = img[::-1]
    return np.ascontiguousarray(img[..., ::-1])


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """Write [H, W, 3] uint8 RGB as an 8-bit RGB PNG (filter 0 on every
    row, one zlib stream)."""
    img = _host(img)
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                                0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_image(path: str, img) -> None:
    """Dispatch on extension (.bmp, else PNG)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.lower().endswith(".bmp"):
        write_bmp(path, img)
    else:
        write_png(path, img)
