"""Device timing on the card by window differences.

Counterpart of ``ray_tracing_tpu/utils/timing.py``. PyTorch hands each CUDA
launch to an asynchronous queue and returns at once, so a host clock read
right after a call measures the enqueue, not the work. Reading every output
back would add one device-to-host copy and one synchronisation per call, a
cost that grows with the window and does not cancel. ``timed_marginal``
instead:

  1. gives every call DISTINCT arguments (a seed-like argument is varied),
     so no two calls are the same request and none can be served from a
     cache;
  2. ends every window by MATERIALIZING the LAST call's outputs on the host
     (one ``.item()`` per output leaf). The card runs a stream's work in
     order, so the last call's value on the host proves that every earlier
     call of the window has run. One materialization per window, whatever
     its size, keeps the synchronisation's cost the same in every window;
  3. reports the DIFFERENCE between a (k1+k)-call window and a k1-call
     window, divided by k, so the launch latency of the first call and the
     final synchronisation cancel and only per-call time remains. If the
     host cannot enqueue as fast as the card executes, the difference
     reports that rate instead: the throughput a caller on this host gets.

Used by the port's bench (``ray_tracing_tpu_torch/bench.py``) and the FMA
peak (``utils/flops.py::measured_vpu_peak``). ``device_seconds`` times a
kernel of a few microseconds, where the host's launch rate would be what a
window difference sees (the gather probe, ``utils/gather_probe.py``).
"""

from __future__ import annotations

import time

import torch
from torch.utils._pytree import tree_leaves

from ray_tracing_tpu_torch.device import resolve_device


def materialize(out) -> float:
    """Pull one element of every tensor leaf of `out` to the host with
    ``.item()`` (which waits for the work that produced it); returns their
    sum. Python numbers are added as they are."""
    total = 0.0
    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor):
            if leaf.numel():
                total += float(leaf.reshape(-1)[0].item())
        elif isinstance(leaf, (int, float)):
            total += float(leaf)
    return total


def timed_marginal(fn, make_args, *, k: int = 4, k1: int = 1, repeats: int = 2):
    """Marginal per-call wall time of `fn`, in seconds.

    make_args(i) -> argument tuple of the i-th call; it MUST vary with i
    (a seed, say). The caller warms `fn` up first (one call with
    make_args(-1)).

    Times a window of k1 calls and one of k1+k calls, each enqueued back to
    back and closed by materializing the LAST call's outputs (one host read
    per window, see the module docstring), and returns
    (t_{k1+k} - t_{k1}) / k. Each window's time is the min over `repeats`
    trials (noise only ever adds time), and the difference is taken between
    those minima."""
    seq = [0]

    def window(n):
        args = []
        for _ in range(n):
            seq[0] += 1
            args.append(make_args(seq[0]))
        t0 = time.perf_counter()
        outs = [fn(*a) for a in args]
        # ONE materialization per window: the last call's outputs prove the
        # whole in-order window executed.
        materialize(outs[-1])
        return time.perf_counter() - t0

    # min per window size across repeats, THEN the difference: a per-repeat
    # difference goes negative whenever the small window catches a stall
    # that the big one missed.
    t_small = min(window(k1) for _ in range(repeats))
    t_big = min(window(k1 + k) for _ in range(repeats))
    return (t_big - t_small) / k


def timed_per_sample(fn, scene, *, n, repeats: int = 2):
    """The bench's protocol: warm `fn(scene, seed)` up once with a distinct
    seed, then its marginal per-call time (seeds 1001, 1002, ..., so no two
    calls are the same request) divided by the `n` samples one call
    renders."""
    make_args = lambda i: (scene, 1000 + i)
    materialize(fn(*make_args(-1)))  # warm up: kernels built and loaded
    return timed_marginal(fn, make_args, repeats=repeats) / n


def environment_fingerprint(device=None, n: int = 16) -> dict:
    """What this host and card add to every call, for a bench line to carry
    beside its rates: the per-launch dispatch floor (n back-to-back
    launches of a trivial one-element kernel, one synchronisation at the
    end, divided by n) and the latency of one ``.item()`` of a value the
    card has just computed (median of 5). Milliseconds, unrounded.
    device=None means the card."""
    device = resolve_device(device)
    s = torch.zeros((), dtype=torch.int32, device=device)
    (s + 1).item()  # the kernel loaded, the queue empty
    t0 = time.perf_counter()
    outs = [s + (100 + i) for i in range(n)]
    outs[-1].item()
    dispatch = (time.perf_counter() - t0) / n

    reads = []
    for i in range(5):
        o = s + (200 + i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        o.item()
        reads.append(time.perf_counter() - t0)
    reads.sort()
    return {"dispatch_ms_per_call": dispatch * 1e3, "item_ms": reads[len(reads) // 2] * 1e3}


# Cycles of the spin kernel that device_seconds enqueues first: about a
# millisecond at the H100's clock, longer than the host takes to enqueue the
# timed calls of a short kernel.
_SPIN_CYCLES = 2_000_000


def device_seconds(fn, n: int, device=None) -> float:
    """Seconds per call of fn(i) for i < n on the card, by CUDA events
    around n back-to-back calls. A spin kernel is enqueued first, so that
    all n calls are queued before the first one runs: for a kernel of a few
    microseconds the host's launch rate would otherwise be what is timed.
    Warm the calls up first. Card only (device=None means the card)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"device_seconds times the card, not {device}")
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / n
