"""Native (C++) runtime components of the port, loaded with ctypes.

Counterpart of ``ray_tracing_tpu/native/__init__.py``: the scene DSL parser,
the PNG screenshot encoder and the keyboard event queue of
``rt_native.cpp`` (this package's own copy of the JAX package's source).
The library is built with the host's C++ compiler at first use into the
package's ``build/`` directory, beside the CUDA libraries of
``kernels/build.py``, and again when the source is newer than it. It is
not a device kernel: every caller has a Python fallback, and ``lib()``
returns None when no compiler is available or the build fails, which is
the JAX package's contract too.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

from ray_tracing_tpu_torch.kernels.build import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / "rt_native.cpp"
LIB_PATH = BUILD_DIR / "librt_native.so"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def find_cxx() -> str | None:
    """The host C++ compiler: $CXX, else g++ or c++ from PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def build(force: bool = False) -> bool:
    """Compile rt_native.cpp into build/librt_native.so unless an up-to-date
    library is there (or `force`). Returns whether a library is there now."""
    if (not force and LIB_PATH.is_file()
            and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime):
        return True
    cxx = find_cxx()
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"librt_native.{os.getpid()}.tmp.so"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees a whole file
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def lib():
    """The loaded library, built on first use; None when it cannot be built
    or loaded (callers then take their Python implementations)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        try:
            l = ctypes.CDLL(str(LIB_PATH))
        except OSError:
            return None

        l.rt_parse_scene.restype = ctypes.c_int
        l.rt_parse_scene.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_char_p, ctypes.c_long,
        ]
        l.rt_write_png.restype = ctypes.c_int
        l.rt_write_png.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        l.rt_events_start.restype = ctypes.c_int
        l.rt_events_start.argtypes = [ctypes.c_int]
        l.rt_events_stop.restype = None
        l.rt_events_stop.argtypes = []
        l.rt_events_pop.restype = ctypes.c_int
        l.rt_events_pop.argtypes = []
        l.rt_events_inject.restype = None
        l.rt_events_inject.argtypes = [ctypes.c_int]
        l.rt_mouse_pos.restype = None
        l.rt_mouse_pos.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        l.rt_events_parse.restype = None
        l.rt_events_parse.argtypes = [ctypes.c_char_p, ctypes.c_long]
        _lib = l
        return _lib
