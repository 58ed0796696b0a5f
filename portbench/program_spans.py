"""What the per-layer metrics of the program's own spans share.

While a torch profiler runs, the port records spans of its layers
(`ray_tracing_tpu_torch/utils/profiling.py::span`): in a frame
"render_image" with "tile_job", a "kernel.<name>" span around each kernel's
launch, "sky_lookup", "compose" and "average"; in a train step "train_step"
with "step.params", "step.forward", "step.loss", "step.backward" and
"step.optimizer". A span is (name, start_ns, end_ns, thread, parent,
counts), on the clock of the profiler's events, so the readers here lay the
spans of the profiled slice over its trace (trace.Trace): host time per unit
in a layer's spans, the CUDA launch calls they hold, and the idle device
time whose gaps' middles they hold.

A unit is a root span of the unit's name ("render_image", "train_step").
A span belongs to the unit its parents lead to; a root on another thread
(autograd runs a card's backward on a thread of its own) is nested by time
in the innermost span of another thread that encloses it.

A program that records no spans (one from before the recorder) gives
nothing to read: every reader returns None.
"""

from __future__ import annotations

import bisect

# The host's calls that launch a kernel, as the profiler names them.
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx"))


def recorded():
    """The spans the program recorded, or None where it records none."""
    try:
        from ray_tracing_tpu_torch.utils.profiling import recorded as program_recorded
    except ImportError:
        return None
    return program_recorded() or None


class Spans:
    """The recorded spans (SpanRecorder's rows) grouped into units."""

    def __init__(self, rows, unit: str):
        self.rows = rows
        self.units = [i for i, r in enumerate(rows)
                      if r[0] == unit and r[4] < 0 and r[2] is not None]
        units = set(self.units)
        self.parent = self._parents(rows, units)
        self.unit_of = {}
        for i in range(len(rows)):
            top = i
            while self.parent[top] >= 0:
                top = self.parent[top]
            if top in units:
                self.unit_of[i] = top

    @staticmethod
    def _parents(rows, units: set) -> list:
        """Each span's parent: its own on its thread; for a root other than
        a unit, the innermost span of another thread that encloses it in
        time (-1 where none does)."""
        parent = [r[4] for r in rows]
        threads = {r[3] for r in rows}
        # spans of the other threads by (start, index): a span opened
        # before, so that no chain of parents comes back to where it began
        others = {tid: sorted((r[1], j) for j, r in enumerate(rows)
                              if r[3] != tid and r[2] is not None) for tid in threads}
        for i, (_, start, end, tid, par, _) in enumerate(rows):
            if par >= 0 or end is None or i in units:
                continue
            cands = others[tid]
            k = bisect.bisect_left(cands, (start, i)) - 1
            while k >= 0 and rows[cands[k][1]][2] < end:
                k -= 1
            if k >= 0:
                parent[i] = cands[k][1]
        return parent

    def outermost(self, names) -> list:
        """Indices of the closed spans named in `names` inside a unit, less
        those inside another such span."""
        names = set(names)
        out = []
        for i, r in enumerate(self.rows):
            if r[0] not in names or r[2] is None or i not in self.unit_of:
                continue
            p = self.parent[i]
            while p >= 0 and self.rows[p][0] not in names:
                p = self.parent[p]
            if p < 0:
                out.append(i)
        return out

    def intervals(self, names) -> list:
        """(start, end) of outermost(names), merged where they overlap, by
        start."""
        merged = []
        for s, e in sorted((self.rows[i][1], self.rows[i][2]) for i in self.outermost(names)):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(iv) for iv in merged]


def spans_of(ctx, unit: str):
    """Spans of the profiled slice with their units, or None where the run
    traced nothing or the program recorded no unit named `unit`."""
    if ctx.trace is None:
        return None
    rows = recorded()
    if rows is None:
        return None
    spans = Spans(rows, unit)
    return spans if spans.units else None


def _inside(intervals, t) -> bool:
    k = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return k >= 0 and intervals[k][1] >= t


def host_ms_per_unit(ctx, unit: str, names):
    """Host time per unit in the spans named in `names`, in ms."""
    spans = spans_of(ctx, unit)
    if spans is None:
        return None
    ns = sum(spans.rows[i][2] - spans.rows[i][1] for i in spans.outermost(names))
    return ns / len(spans.units) * 1e-6


def launches_per_unit(ctx, unit: str, names):
    """The profiler's kernel-launch calls of the host whose start lies in a
    span named in `names`, per unit."""
    spans = spans_of(ctx, unit)
    if spans is None:
        return None
    intervals = spans.intervals(names)
    n = sum(1 for start, _, name in ctx.trace.host_ops
            if name in LAUNCHES and _inside(intervals, start))
    return n / len(spans.units)


def idle_share_in(ctx, unit: str, names):
    """Share of the slice's idle device time whose gaps' middles fall in a
    span named in `names`, in %."""
    spans = spans_of(ctx, unit)
    if spans is None:
        return None
    gaps = ctx.trace.gaps
    idle = sum(g1 - g0 for g0, g1 in gaps)
    if idle <= 0:
        return None
    intervals = spans.intervals(names)
    held = sum(g1 - g0 for g0, g1 in gaps if _inside(intervals, (g0 + g1) // 2))
    return held / idle * 100.0
