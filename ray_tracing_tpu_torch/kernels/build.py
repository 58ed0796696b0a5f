"""Builds the port's CUDA sources with nvcc at first use and loads them with
ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>.so`` inside the package
directory (``build/`` is not under version control). The sources expose a
plain C interface and include no PyTorch header, so a build takes seconds.
Nothing here runs at import: the first launch of a kernel calls
``load_library``. A compiler that is missing, a build that fails or a
library that does not load raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"

# --fmad=false: nvcc would contract a*b+c into one fused multiply-add, which
# rounds once where PyTorch's separate kernels round twice; a last-bit
# difference can flip a hit/miss or specular/diffuse decision and change the
# whole pixel. No fast-math: the slab tests rely on IEEE inf and NaN.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from the toolkit's usual place."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA "
        "kernels of ray_tracing_tpu_torch are compiled where they run"
    )


def build_library(name: str, verbose: bool = False) -> dict:
    """Compile csrc/<name>.cu into build/lib<name>.so, whatever is there
    already. Returns {"path", "seconds", "log", "command"}; with `verbose`
    the log holds ptxas' per-kernel registers, shared memory and spills."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}.so"
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees a whole file
    return {"path": str(out), "seconds": seconds, "log": log, "command": " ".join(cmd)}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first when it is missing
    or older than its source."""
    with _lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}.so"
        if not out.is_file() or out.stat().st_mtime < src.stat().st_mtime:
            build_library(name)
        lib = ctypes.CDLL(str(out))
        _libraries[name] = lib
        return lib

