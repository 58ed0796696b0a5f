"""Image output: float frames to 8-bit PNG files.

Counterpart of ``ray_tracing_tpu/io/image.py`` (to_uint8, save_png). The PNG
encoder is a small one on the standard library's zlib, so that writing a
frame needs no imaging package; ``read_png`` reads back what ``write_png``
wrote, and ``png_size`` reads any PNG's header.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def to_uint8(img) -> np.ndarray:
    """float [0,1] -> uint8 by the reference's conversion: x*255 truncated.
    Takes a numpy array or a tensor on any device."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float32)
    return (img * 255.0).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(arr: np.ndarray, path) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (filter 0 rows)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {arr.shape} {arr.dtype}")
    h, w, _ = arr.shape
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = 0  # filter type None
    raw[:, 1:] = arr.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (
        _PNG_MAGIC
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(data)


def _chunks(data: bytes):
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r} chunk")
        yield tag, body
        pos += 12 + length


def png_size(path) -> tuple[int, int, int, int]:
    """(width, height, bit depth, colour type) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != _PNG_MAGIC or head[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    w, h, depth, colour = struct.unpack(">IIBB", head[16:26])
    return w, h, depth, colour


def read_png(path) -> np.ndarray:
    """Read an 8-bit RGB PNG whose rows all use filter 0 (what write_png
    writes) into an (H, W, 3) uint8 array; raises on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    w = h = None
    idat = b""
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, colour, interlace) != (8, 2, 0):
                raise ValueError("only 8-bit non-interlaced RGB PNGs are read")
        elif tag == b"IDAT":
            idat += body
    if w is None:
        raise ValueError("PNG without IHDR")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError("only filter-0 rows are read")
    return raw[:, 1:].reshape(h, w, 3).copy()


def save_png(img, path, flip_vertically: bool = True) -> None:
    """Write an (H, W, 3) float [0,1] frame as PNG. flip_vertically=True
    matches the reference's screenshots: the renderer's row 0 is the
    reference's row 0, and its writer flips rows on save."""
    arr = to_uint8(img)
    if flip_vertically:
        arr = arr[::-1]
    write_png(arr, path)
