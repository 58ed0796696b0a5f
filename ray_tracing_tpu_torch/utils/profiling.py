"""Tracing and throughput metrics.

Counterpart of ``ray_tracing_tpu/utils/profiling.py``: the reference's ray
accounting, a sliding-window rays/s meter, and a ``torch.profiler`` trace (a
Chrome trace file, for chrome://tracing or Perfetto) in place of
``jax.profiler``.

Beside them, the program's own spans: ``span(name, **counts)`` marks a
layer of the frame or the train step (the TileJob build, each kernel
launch, the sky lookup, compose; the step's forward, loss, backward and
optimizer). Spans are kept only while a torch profiler runs in the process,
on the clock of the profiler's events (``time.time_ns``), so that a reader
can lay them over the profiler's host and device events; otherwise a span
is one shared no-op context.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

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
    ``<log_dir>/trace.json``, the program's spans of the block included
    (category "span", on their threads' rows, on the profiler's clock).
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in recorded() if s[1] >= t0 and s[2] is not None])


def _add_spans(path: str, spans) -> None:
    """Write `spans` into the Chrome trace at `path` as complete events.
    The trace's times are microseconds from its baseTimeNanoseconds."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "span", "name": name, "pid": pid, "tid": tid,
         "ts": (start - base) / 1e3, "dur": (end - start) / 1e3, "args": counts}
        for name, start, end, tid, _, counts in spans)
    with open(path, "w") as f:
        json.dump(doc, f)


# -- the program's spans ---------------------------------------------------

# Spans kept until clear(); past it a span is dropped and counted. A traced
# frame of 8 samples opens 27 spans, a train step about 41.
SPAN_CAP = 200_000


class SpanRecorder:
    """The program's spans, in the order they opened.

    recorded() gives each span as (name, start_ns, end_ns, thread, parent,
    counts): times of time.time_ns, the clock of the profiler's events
    (end_ns is None while the span is open); the thread's native id, as the
    profiler's trace names threads; the index of the innermost span open on
    the same thread when it opened, -1 for a root; and the integer counts
    the caller gave. Autograd runs a card's backward on a thread of its
    own, where its spans are roots: readers nest them by time.

    Rows are appended without a lock (a list's append is atomic), so spans
    opened at once on several threads may pass the cap by one each."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self.rows: list = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def thread_stack(self) -> list:
        """This thread's open spans, innermost last: their rows, None for a
        dropped span."""
        local = self._local
        if not hasattr(local, "stack"):
            local.tid, local.stack = threading.get_native_id(), []
        return local.stack

    def drop(self) -> None:
        with self._lock:
            self.dropped += 1

    def recorded(self) -> list:
        rows = list(self.rows)
        # a row names its parent's row: give its index (-1 for a row cleared)
        index = {id(r): i for i, r in enumerate(rows)}
        return [(r[0], r[1], r[2], r[3], index.get(id(r[4]), -1), dict(r[5])) for r in rows]

    def clear(self) -> None:
        with self._lock:
            self.rows = []
            self.dropped = 0


class _Span:
    """One span while it is open: its row [name, start_ns, end_ns, thread,
    parent row, counts] in the recorder, None when dropped."""

    __slots__ = ("recorder", "name", "counts", "row", "stack")

    def __init__(self, recorder: SpanRecorder, name: str, counts: dict):
        self.recorder, self.name, self.counts = recorder, name, counts

    def __enter__(self):
        rec = self.recorder
        stack = rec.thread_stack()
        rows = rec.rows
        if len(rows) >= rec.cap:
            rec.drop()
            row = None
        else:
            row = [self.name, time.time_ns(), None, rec._local.tid,
                   stack[-1] if stack else None, self.counts]
            rows.append(row)
        stack.append(row)
        self.row, self.stack = row, stack
        return self

    def __exit__(self, *exc):
        if self.row is not None:
            self.row[2] = time.time_ns()
        self.stack.pop()
        return False


RECORDER = SpanRecorder()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether spans are kept now: a torch profiler runs in the process.
    A caller whose counts cost work computes them only then."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, **counts):
    """A context manager that marks a layer of the program as `name`, with
    integer `counts` the host already knows (a frame's pixels and samples,
    a sky lookup's texels). It keeps the span only while a torch profiler
    runs in the process (any activities); otherwise it is one shared no-op
    context and keeps nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(RECORDER, name, counts)


def recorded() -> list:
    """A copy of the spans kept so far (SpanRecorder.recorded)."""
    return RECORDER.recorded()


def dropped() -> int:
    """Spans dropped past the cap since the last clear()."""
    return RECORDER.dropped


def clear() -> None:
    """Forget the spans kept so far and the count of dropped ones."""
    RECORDER.clear()


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
