"""What every cell shares: the benchmark's file, the lookup of a cell's
configuration, traffic mix, load kind, limits and per-layer metric readers
by name, the measured window with its spans, and the result line.

Nothing here names a configuration, a mix or a metric: a later change adds
one as files under portbench/ and entries in BENCHMARK.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracing_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything found by its names."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    limits: dict          # {number: {"limit": ...}} of portbench/limits/<cell>.json
    root: pathlib.Path    # the checkout


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its configuration file, its
    traffic file portbench/traffic/<traffic>.json and its limits file
    portbench/limits/<cell>.json (empty where there is none yet), all
    under the checkout `root`."""
    bench = load_json(root / "BENCHMARK.json")
    package = root / "portbench"
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(package / "traffic" / f"{work['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _reports(m, name)]
    limits_path = package / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.is_file() else {}
    return Cell(name, config, traffic, work["chips"], e2e, per_layer, limits, root)


def load_kind(kind: str):
    """The load generator portbench/kinds/<kind>.py that a traffic file
    names: a module with a class Load."""
    return importlib.import_module(f"portbench.kinds.{kind}").Load


def metric_reader(root: pathlib.Path, name: str):
    """read(ctx) of portbench/metrics/<name>.py under the checkout `root`
    (the file is named after the metric, dots and all)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


class Window:
    """The measured window: `more()` says whether it is still open, `span`
    times host work by name. With a profiler and a slice (a (start, length)
    pair in seconds from the window's start) it profiles that slice. Once
    the profiler has started, CUDA's tracing slows every launch of the
    process for the rest of it, so a traced run's readings and spans are
    those of the units begun before the slice (`before_slice`)."""

    def __init__(self, seconds: float, profiler=None, slice_at=None):
        self.seconds = seconds
        self.profiler = profiler
        self.slice_at = slice_at if profiler is not None else None
        self.spans: dict[str, list[float]] = {}
        self.slice_spans: list[tuple[str, int, int]] = []
        self.in_slice = False
        self.slice_done = False
        self.units = 0
        self.units_before_slice = None
        self.slice_units = 0
        self.t0 = self.deadline = self.slice_t0 = self.readings_end = None
        self.slice_s = 0.0

    @property
    def profiled(self) -> bool:
        """Whether the profiler has started (and still taxes the host)."""
        return self.in_slice or self.slice_done

    def open(self) -> None:
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds

    def more(self) -> bool:
        """Whether to start another unit of work; starts and stops the
        profiled slice on the way."""
        now = time.perf_counter()
        if self.slice_at is not None:
            start, length = self.slice_at
            if not self.profiled and now >= self.t0 + start:
                self.units_before_slice = self.units
                self.readings_end = now
                self.profiler.start()  # the first start takes seconds
                self.in_slice = True
                now = self.slice_t0 = time.perf_counter()
            elif self.in_slice and now >= self.slice_t0 + length:
                self.close_slice()
        if now >= self.deadline:
            return False
        self.units += 1
        if self.in_slice:
            self.slice_units += 1
        return True

    def before_slice(self, elapsed: float, units: int) -> tuple[float, int]:
        """(seconds, units) that the readings cover: the whole window, or in
        a traced run the part before the profiler started."""
        if self.units_before_slice is None:
            return elapsed, units
        return self.readings_end - self.t0, self.units_before_slice

    def close_slice(self) -> None:
        if self.in_slice:
            self.slice_s = time.perf_counter() - self.slice_t0
            self.profiler.stop()
            self.in_slice = False
            self.slice_done = True

    @contextlib.contextmanager
    def span(self, name: str):
        if self.in_slice:
            t0 = time.time_ns()  # the profiler's clock
            yield
            self.slice_spans.append((name, t0, time.time_ns()))
            return
        t0 = time.perf_counter()
        yield
        if not self.profiled:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between the
    closest ranks, as numpy's default."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at or
    under its limit. A number without a limit, or a limit without a number,
    is not correct."""
    out, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name)
        limit = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not (value == value) or value > limit:
            ok = False
    return ok, out
