"""Probe: how fast does the card gather from a small table?

    python -m ray_tracing_tpu_torch.utils.gather_probe

Counterpart of ``benchmarks/vmem_gather_probe.py`` (TPU kernel P1): a
256 KB int32 table, 2M int32 indices, out = table[idx], through the CUDA
kernels of ``kernels/csrc/gather_probe.cu`` (7/8 of this table is copied
into the shared memory of every SM, as the TPU kernel kept it in VMEM; the
rest, and the sky's large table, are read through L1 and L2) and through
PyTorch's indexing ``table[idx]`` on the same int32 indices, the library
gather. Prints ``correct=...`` (kernel against ``torch.take``, integers,
bit for bit), then each one's time and ns per index, ``torch.take``'s (it
takes int64 indices only, so it reads 8 MB more), then the least time the
card could take (bytes over the memory rate). It is module 8's question in
small: the sky lookup is such a gather (ops/cubemap.py), which the JAX
package's sparse sky lookup avoids and the port does in full.

``gather`` is the kernel's wrapper: the CUDA kernel for tensors on the card,
``gather_plain`` (``torch.take``) for tensors on the CPU; nothing else
decides between them.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels import build
from ray_tracing_tpu_torch.utils.timing import device_seconds

LIBRARY = "gather_probe"
TABLE = 64 * 1024          # 256 KB of int32
TILE = (512, 128)          # the TPU kernel's block of indices
N_IDX = 2 * 1024 * 1024    # about one 1920x1080 plane of indices
R = 8                      # distinct index planes per timing (64 MB: past the 50 MB L2)
PEAK_BYTES = 3.35e12       # H100 SXM memory rate (NVIDIA's data sheet)

# Launches of the kernel, raised where it is launched and nowhere else.
launch_counts = {"gather_probe": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(table, idx) -> None:
    for name, t in (("table", table), ("idx", idx)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.dim() != 1:
        raise ValueError(f"table must be 1-D, got shape {tuple(table.shape)}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device} but idx on {idx.device}")


def gather_plain(table, idx):
    """table[idx] in PyTorch: torch.take, idx's shape."""
    _check(table, idx)
    return torch.take(table, idx.to(torch.int64))


def _function():
    lib = build.load_library(LIBRARY)
    fn = lib.rt_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(table, idx):
    lib, fn = _function()
    with torch.cuda.device(idx.device):
        # at idx's offset from a 16-byte boundary (the allocator's blocks are
        # aligned): the kernel needs both to reach one after the same head
        phase = idx.data_ptr() % 16 // idx.element_size()
        out = torch.empty(idx.numel() + phase, dtype=idx.dtype,
                          device=idx.device)[phase:].view(idx.shape)
        err = fn(table.data_ptr(), table.numel(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                 torch.cuda.current_stream(idx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather launch failed: {lib.rt_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    launch_counts["gather_probe"] += 1
    return out


def gather(table, idx):
    """out = table[idx] (int32 1-D table, contiguous int32 indices of any
    shape, at any storage offset): the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU. An index outside the table
    fails on the card (the kernel traps) and raises on the CPU. On the card
    the result lies at idx's offset from a 16-byte boundary in its storage."""
    _check(table, idx)
    if idx.device.type == "cuda":
        if table.numel() >= 2 ** 31:
            raise ValueError("the table must have fewer than 2^31 entries")
        if idx.numel() == 0:
            return torch.empty_like(idx)
        return _launch(table, idx)
    if idx.device.type != "cpu":
        raise ValueError(f"unsupported device {idx.device}")
    return gather_plain(table, idx)


def probe_inputs(device):
    """The probe's table and indices, from fixed seeds on `device`."""
    gen = torch.Generator(device=device).manual_seed(0)
    table = torch.randint(0, 1 << 30, (TABLE,), generator=gen, dtype=torch.int32, device=device)
    gen.manual_seed(1)
    idx = torch.randint(0, TABLE, (N_IDX // TILE[1], TILE[1]), generator=gen,
                        dtype=torch.int32, device=device)
    return table, idx


def bound_seconds(table_entries: int, n_idx: int) -> float:
    """Least time of the gather: the table read once, every index read once
    and every result written once, 4 bytes each, at the memory rate."""
    return 4 * (table_entries + 2 * n_idx) / PEAK_BYTES


def run(device=None) -> dict:
    """Check the kernel against torch.take, then time it, table[idx] on the
    same int32 indices and torch.take on int64 copies of them over R
    distinct index planes (indices XOR r, which stay inside the power-of-two
    table). Card only: device=None means the card."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe times the card, not {device}")
    table, idx = probe_inputs(device)
    correct = bool(torch.equal(gather(table, idx), gather_plain(table, idx)))
    planes = [idx ^ (r & 0x3FF) for r in range(R)]
    planes64 = [p.to(torch.int64) for p in planes]
    for r in range(R):  # warm: library loaded, every plane touched once
        gather(table, planes[r])
        table[planes[r]]
        torch.take(table, planes64[r])
    kernel_s = device_seconds(lambda i: gather(table, planes[i % R]), 2 * R, device)
    library_s = device_seconds(lambda i: table[planes[i % R]], 2 * R, device)
    take_s = device_seconds(lambda i: torch.take(table, planes64[i % R]), 2 * R, device)
    return {"correct": correct, "table_entries": TABLE, "n_idx": N_IDX,
            "kernel_ms": kernel_s * 1e3, "library_ms": library_s * 1e3,
            "take_int64_ms": take_s * 1e3,
            "bound_ms": bound_seconds(TABLE, N_IDX) * 1e3,
            "kernel_ns_per_idx": kernel_s / N_IDX * 1e9,
            "library_ns_per_idx": library_s / N_IDX * 1e9,
            "take_int64_ns_per_idx": take_s / N_IDX * 1e9}


def report(res: dict) -> str:
    """The probe's printed lines: correct=..., each gather's time and ns per
    index, the bound."""
    return "\n".join([
        f"correct={res['correct']}",
        f"cuda gather kernel: {res['kernel_ms']:.4f} ms for {res['n_idx']} idx "
        f"= {res['kernel_ns_per_idx']:.5f} ns/idx",
        f"table[idx], int32:  {res['library_ms']:.4f} ms for {res['n_idx']} idx "
        f"= {res['library_ns_per_idx']:.5f} ns/idx",
        f"torch.take, int64:  {res['take_int64_ms']:.4f} ms for {res['n_idx']} idx "
        f"= {res['take_int64_ns_per_idx']:.5f} ns/idx",
        f"bound (bytes at {PEAK_BYTES / 1e12} TB/s): {res['bound_ms']:.4f} ms",
    ])


def main() -> int:
    res = run()
    print(report(res))
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
