"""The FP32 FMA peak kernel: its wrapper and its plain PyTorch version.

Counterpart of ``ray_tracing_tpu/utils/flops.py::_peak_kernel``: eight
chains x <- x*x + a per element of `a`, summed. ``peak_fma`` launches
``csrc/peak_fma.cu`` for a tensor on the card and runs ``peak_fma_plain``
for a tensor on the CPU; nothing else decides between them.
``utils/flops.py::measured_vpu_peak`` times it.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tracing_tpu_torch.kernels import build

LIBRARY = "peak_fma"
CHAINS = 8
UNROLL = 64  # iters must be a multiple of the kernel's unrolled body

# Launches of the kernel, raised where it is launched and nowhere else.
launch_counts = {"peak_fma": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(a, iters: int) -> None:
    if not isinstance(a, torch.Tensor) or a.dtype != torch.float32:
        raise TypeError("a must be a float32 tensor")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    if iters < UNROLL or iters % UNROLL:
        raise ValueError(f"iters must be a positive multiple of {UNROLL}, got {iters}")


def peak_fma_plain(a, iters: int):
    """The recurrence in PyTorch: per element, chains a + 0.01*k (k < 8),
    each iterated x <- x*x + a `iters` times (the product rounded before the
    add), summed left to right."""
    _check(a, iters)
    xs = [a + 0.01 * k for k in range(CHAINS)]
    for _ in range(iters):
        xs = [x * x + a for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _function():
    lib = build.load_library(LIBRARY)
    fn = lib.rt_peak_fma
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(a, iters: int):
    lib, fn = _function()
    with torch.cuda.device(a.device):
        out = torch.empty_like(a)
        err = fn(a.data_ptr(), out.data_ptr(), a.numel(), iters,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"peak_fma launch failed: {lib.rt_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    launch_counts["peak_fma"] += 1
    return out


def peak_fma(a, iters: int):
    """The eight-chain FMA recurrence of every element of `a` (float32,
    contiguous, any shape) after `iters` steps: the CUDA kernel for a tensor
    on the card, the plain version for one on the CPU."""
    _check(a, iters)
    if a.device.type == "cuda":
        return _launch(a, iters)
    if a.device.type != "cpu":
        raise ValueError(f"unsupported device {a.device}")
    return peak_fma_plain(a, iters)
