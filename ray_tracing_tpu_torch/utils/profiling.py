"""Tracing and throughput metrics.

Counterpart of ``ray_tracing_tpu/utils/profiling.py``: the reference's ray
accounting, a synchronised timer, a sliding-window rays/s meter, and a
``torch.profiler`` trace (a Chrome trace file, for chrome://tracing or
Perfetto) in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._pytree import tree_leaves

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG


def traces_per_sample(config: RenderConfig = DEFAULT_CONFIG) -> int:
    """Closest-hit traces each pixel-sample dispatches: bounces x (1 primary
    + shadow_samples next-event rays), the reference's cost model."""
    return config.bounces * (1 + config.shadow_samples)


def rays_per_frame(width: int, height: int, spp: int = 1,
                   config: RenderConfig = DEFAULT_CONFIG) -> int:
    return width * height * spp * traces_per_sample(config)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, host and (with a card) device
    activity; on exit the Chrome trace is written to
    ``<log_dir>/trace.json``. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(out) -> None:
    """Wait for the work behind every CUDA tensor leaf of `out`; CPU tensors
    are ready when they are returned."""
    for dev in {t.device for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def timed(fn, *args, iters: int = 1, **kwargs):
    """(result, seconds per call): one warm-up call, then `iters` calls
    timed on the host's clock up to the end of their device work."""
    result = fn(*args, **kwargs)
    _synchronize(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    _synchronize(result)
    return result, (time.perf_counter() - t0) / iters


class RateMeter:
    """Sliding-window rays/s meter for interactive loops."""

    def __init__(self, window: int = 16):
        self.window = window
        self.samples: list[tuple[float, int]] = []

    def add(self, rays: int) -> None:
        self.samples.append((time.perf_counter(), rays))
        if len(self.samples) > self.window:
            self.samples.pop(0)

    @property
    def rays_per_second(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        dt = self.samples[-1][0] - self.samples[0][0]
        rays = sum(r for _, r in self.samples[1:])
        return rays / dt if dt > 0 else 0.0

    def format(self) -> str:
        r = self.rays_per_second
        if r >= 1e9:
            return f"{r / 1e9:.2f} Grays/s"
        return f"{r / 1e6:.1f} Mrays/s"
