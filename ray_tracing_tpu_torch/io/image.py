"""Image IO: skybox loading, PNG frames and screenshots.

Counterpart of ``ray_tracing_tpu/io/image.py``. Decoding (``load_image``,
``load_cubemap``) goes through PIL, imported where it is used. Writing has
two encoders: the native one of ``rt_native.cpp`` (``save_png`` takes it
when the library loads) and a small one on the standard library's zlib
(``encode_png``), so that writing a frame needs no imaging package;
``read_png`` reads back what either writes, and ``png_size`` reads any
PNG's header.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import struct
import tempfile
import zlib

import numpy as np
import torch

from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.ops.cubemap import (
    CF_BACK,
    CF_BOTTOM,
    CF_FRONT,
    CF_LEFT,
    CF_RIGHT,
    CF_TOP,
    CubemapData,
)

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

# The skybox faces under an asset root, in the reference's face order
# (src/main.c:500-507).
SKYBOX_FILES = {
    CF_RIGHT: "skybox/right.jpg",
    CF_LEFT: "skybox/left.jpg",
    CF_TOP: "skybox/top.jpg",
    CF_BOTTOM: "skybox/bottom.jpg",
    CF_FRONT: "skybox/front.jpg",
    CF_BACK: "skybox/back.jpg",
}


def load_image(path) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def skybox_cache_dir() -> pathlib.Path:
    """Where load_cubemap keeps its decoded skyboxes: a directory of this
    package's own under the temporary directory, apart from the JAX
    package's."""
    return pathlib.Path(tempfile.gettempdir()) / f"rtt_torch_skybox_{os.getuid()}"


def load_cubemap(asset_root, use_cache: bool = True, device=None) -> CubemapData:
    """The six-face skybox under `asset_root` (SKYBOX_FILES), packed to one
    0x00RRGGBB texel per pixel on `device` (device=None means the card).

    Decoding six 2048^2 JPEGs costs seconds of one CPU core, so the packed
    texels are kept as an npz file in skybox_cache_dir(), keyed on the
    files' identity (path, mtime, size); a changed file changes the key,
    and a cache file that does not read back is decoded again."""
    device = resolve_device(device)  # before seconds of decoding
    root = pathlib.Path(asset_root)
    paths = [root / SKYBOX_FILES[face] for face in range(6)]

    cache = None
    if use_cache:
        try:
            ident = "".join(
                f"{p}:{p.stat().st_mtime_ns}:{p.stat().st_size};" for p in paths)
        except OSError:
            ident = None  # load_image raises its own error below
        if ident is not None:
            key = hashlib.sha1(ident.encode()).hexdigest()[:16]
            cache = skybox_cache_dir() / f"{key}.npz"
            if cache.exists():
                try:
                    with np.load(cache) as z:
                        packed = z["packed"]
                        h, w = int(z["h"]), int(z["w"])
                    if packed.dtype == np.int32 and packed.shape == (6 * h * w,):
                        return CubemapData(torch.from_numpy(packed).to(device), None,
                                           None, None, h, w)
                except (OSError, ValueError, KeyError):
                    pass  # decode again below

    faces = np.stack([load_image(p) for p in paths])
    cm = CubemapData.from_faces(faces, device=device)
    if cache is not None:
        try:
            cache.parent.mkdir(parents=True, exist_ok=True)
            tmp = cache.with_suffix(f".{os.getpid()}.tmp")
            with open(tmp, "wb") as f:  # a file object: savez must not add .npz
                np.savez(f, packed=cm.packed.cpu().numpy(), h=np.int64(cm.h),
                         w=np.int64(cm.w))
            os.replace(tmp, cache)  # atomic: a concurrent loader sees a whole file
        except OSError:
            pass  # the cache is best-effort
    return cm


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


def encode_png(arr: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 array as the bytes of an 8-bit RGB PNG (filter 0
    rows)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {arr.shape} {arr.dtype}")
    h, w, _ = arr.shape
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = 0  # filter type None
    raw[:, 1:] = arr.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _PNG_MAGIC
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(arr: np.ndarray, path) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (encode_png)."""
    data = encode_png(arr)
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


def save_png(img, path, flip_vertically: bool = True, use_native: bool = True) -> None:
    """Write an (H, W, 3) float [0,1] frame as PNG. flip_vertically=True
    matches the reference's screenshots: the renderer's row 0 is the
    reference's row 0, and its writer flips rows on save. The native
    encoder (rt_native.cpp rt_write_png) writes it when `use_native` and
    the library loads; write_png otherwise."""
    arr = np.ascontiguousarray(to_uint8(img))
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) frame, got {arr.shape}")
    if use_native:
        from ray_tracing_tpu_torch import native

        lib = native.lib()
        if lib is not None:
            rc = lib.rt_write_png(
                str(path).encode(), arr.shape[1], arr.shape[0],
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                1 if flip_vertically else 0,
            )
            if rc == 0:
                return
    if flip_vertically:
        arr = arr[::-1]
    write_png(arr, path)


def next_screenshot_path(directory=".") -> str | None:
    """The first free screenshot_<i>.png for i < 1000 (src/main.c:642-659)."""
    for i in range(1000):
        path = os.path.join(directory, f"screenshot_{i}.png")
        if not os.path.exists(path):
            return path
    return None


def screenshot(img, directory=".") -> str | None:
    """Save the frame as the reference's SPACE handler does
    (src/main.c:637-681); the path written, or None when every name is
    taken."""
    path = next_screenshot_path(directory)
    if path is not None:
        save_png(img, path, flip_vertically=True)
    return path
