"""The traced slice of a `--trace 1` run: torch.profiler over a few steady
seconds inside the window, reduced to what the per-layer metrics and the
result's `breakdown` read.

Device work is every event that the profiler puts on the card (kernels,
copies, fills). The slice's device window runs from the first of them to
the last: work launched before the profiler started is not in the trace,
and the host's wait for it would otherwise read as idle time.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str        # "kernel", "memcpy" or "memset"
    start: int       # ns, the profiler's clock (time.time_ns)
    end: int


@dataclasses.dataclass
class Trace:
    ops: list                 # DeviceOp, by start
    window_ns: tuple          # (first device op's start, last one's end)
    busy_ns: int              # union of the device ops inside the window
    gaps: list                # (start, end) of the idle stretches
    host_ops: list            # (start, end, name) of the host's profiled ops
    spans: list               # (name, start, end) of the benchmark's spans
    units: int                # units of work begun inside the slice

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def kernels(self, match=None) -> list:
        return [o for o in self.ops if o.kind == "kernel" and (match is None or match(o.name))]

    def seconds(self, ops) -> float:
        return sum(o.end - o.start for o in ops) * 1e-9

    def gap_labels(self) -> dict:
        """Idle seconds by what the host was doing at each gap's middle: the
        benchmark's innermost span, and inside it the innermost profiled
        host op ("-" where none)."""
        span_iv = sorted((s, e, n) for n, s, e in self.spans)
        out = {}
        for g0, g1 in self.gaps:
            mid = (g0 + g1) // 2
            span = _covering(span_iv, mid) or "outside spans"
            label = f"{span} / {_covering(self.host_ops, mid) or '-'}"
            out[label] = out.get(label, 0) + (g1 - g0)
        return {k: v * 1e-9 for k, v in out.items()}

    def breakdown(self) -> dict:
        by_name = {}
        for o in self.ops:
            name = short_name(o.name)
            by_name[name] = by_name.get(name, 0) + (o.end - o.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gap_labels().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, ns * 1e-9] for n, ns in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without "void", its namespaces' noise and its
    argument list, at most `width` characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:width]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = name.replace("at::native::", "")
    return name.split("(", 1)[0][:width]


def _covering(intervals, t, look_back: int = 64):
    """Name of the interval of `intervals` ((start, end, name), by start)
    with the latest start at or before t that still covers t: the
    innermost, where intervals nest."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    for j in range(i, max(i - look_back, -1), -1):
        s, e, n = intervals[j]
        if e >= t:
            return n
    return None


class Profiler:
    """torch.profiler over the card's activity, started and stopped by the
    window."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        """Profile the card's activity alone: its kernels, copies and fills,
        and the host's CUDA runtime calls. Recording every host op as well
        made a frame 1.8 times as long in the slice, which then read
        the device as idle where the unprofiled run keeps it busy."""
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.prof.stop()

    def reduce(self, spans, units: int) -> Trace | None:
        """The Trace of the profiled slice; None where no device op was
        traced (no card, or no device activity in the trace)."""
        if self.prof is None:
            return None
        ops, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue  # the benchmark's spans, on the host's and the device's rows
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                name = e.name()
                kind = ("memcpy" if name.startswith("Memcpy") else
                        "memset" if name.startswith("Memset") else "kernel")
                ops.append(DeviceOp(name, kind, e.start_ns(), e.end_ns()))
            else:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        self.prof = None
        if not ops:
            return None
        ops.sort(key=lambda o: o.start)
        host.sort()
        w0, w1 = ops[0].start, max(o.end for o in ops)
        busy, gaps, cur_s, cur_e = 0, [], ops[0].start, ops[0].end
        for o in ops[1:]:
            if o.start > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, o.start))
                cur_s, cur_e = o.start, o.end
            else:
                cur_e = max(cur_e, o.end)
        busy += cur_e - cur_s
        return Trace(ops, (w0, w1), busy, gaps, host, list(spans), units)
