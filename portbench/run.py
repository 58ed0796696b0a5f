"""Run one cell of the benchmark once, on the card of the machine it starts
on, and print its result as the last line of standard output:

    python3 -m portbench.run --workload scene2.render --seed 7 --seconds 10 --trace 0

from the root of a checkout. `--trace 0` reports the cell's end-to-end
metrics, `--trace 1` its per-layer metrics, read from a profiled slice of
the window. Earlier lines say what the run ran on: the card, its power
limit and clocks, the host's dispatch floor, the cell's load and the work
behind each roofline share. The numbers that decide `correct` are printed
beside their limits as the last lines of standard error and as the last key
of the result.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits with 3; where the program loaded is not the checkout's
(or is missing), with 4; where JAX or the JAX package is loaded once the
window has closed, with 5.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

GIB = float(1 << 30)
# Where the profiled slice of a traced window lies: from this share of the
# window, for this share of it but at most SLICE_MAX_S seconds.
SLICE_FROM, SLICE_SHARE, SLICE_MAX_S = 0.4, 0.3, 3.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    """Name, power limit and draw, clocks and temperature of every card, as
    nvidia-smi reads them ("not available" where it does not run)."""
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip().replace("\n", " | ") or "not available"


def fingerprint(device) -> dict:
    """The host's per-launch dispatch floor (16 back-to-back launches of a
    one-element kernel, one synchronisation) and the latency of one .item()
    of a value the card has just computed (median of 5), in ms."""
    import torch

    s = torch.zeros((), dtype=torch.int32, device=device)
    (s + 1).item()
    t0 = time.perf_counter()
    outs = [s + (100 + i) for i in range(16)]
    outs[-1].item()
    dispatch = (time.perf_counter() - t0) / 16
    reads = []
    for i in range(5):
        o = s + (200 + i)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        o.item()
        reads.append(time.perf_counter() - t0)
    reads.sort()
    return {"dispatch_ms_per_call": dispatch * 1e3, "item_ms": reads[2] * 1e3}


class Context:
    """What a per-layer metric's reader (portbench/metrics/<name>.py) gets:
    `trace` (trace.Trace of the profiled slice, None where nothing was
    traced), `spans` ({name: [seconds]} of the benchmark's spans before
    the slice), `readings` (the window's end-to-end readings, before the
    slice) and `work`
    ({kernel: bound dict} of roofline.py for one launch)."""

    def __init__(self, trace, spans, readings, work):
        self.trace, self.spans, self.readings, self.work = trace, spans, readings, work


def run_cell(cell, seed: int, seconds: float, traced: bool, device, faults=None,
             t_start: float = T_START) -> dict:
    """One run of `cell` (harness.Cell) on `device`; returns the result's
    dict. `faults` (tests and calibration only) go to the load's set-up."""
    import torch

    from portbench import harness
    from portbench.trace import Profiler

    cuda = device.type == "cuda"
    print(f"portbench: cell {cell.name} seed {seed} seconds {seconds} trace {int(traced)}",
          flush=True)
    if cuda:
        print(f"portbench: card {torch.cuda.get_device_name(device)} | nvidia-smi: "
              f"{nvidia_smi()}", flush=True)
        print(f"portbench: torch {torch.__version__} cuda {torch.version.cuda} "
              f"fingerprint {json.dumps(fingerprint(device))}", flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    load = harness.load_kind(cell.traffic["kind"])(cell.config, cell.traffic, seed, device)
    profiler = Profiler() if traced else None
    load.setup(**(faults or {}))
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"portbench: load {json.dumps(load.info)} setup_s {setup_s}", flush=True)

    slice_at = (SLICE_FROM * seconds, min(SLICE_SHARE * seconds, SLICE_MAX_S))
    win = harness.Window(seconds, profiler if cuda else None, slice_at)
    readings = load.window(win)
    if cuda:
        torch.cuda.synchronize(device)
        peak_alloc = torch.cuda.max_memory_allocated(device)
        peak_reserved = torch.cuda.max_memory_reserved(device)
    else:
        peak_alloc = peak_reserved = 0
    readings.update(setup_s=setup_s, peak_mem_GiB=peak_alloc / GIB)
    found = harness.forbidden_modules(sys.modules)
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")
    trace = profiler.reduce(win.slice_spans, win.slice_units) if (traced and cuda) else None
    if trace is not None:
        log(f"portbench: profiled slice: {win.slice_units} units in {win.slice_s:.3f} s, "
            f"{win.slice_s / max(win.slice_units, 1) * 1e3:.3f} ms each; the window: "
            f"{load.attempted} units in {seconds} s; readings from the "
            f"{win.units_before_slice} units before the slice")
    log(f"portbench: window closed: {load.attempted} units, readings {json.dumps(readings)}")

    load.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = load.check()
    correct, compared = harness.judge(numbers, cell.limits)
    log(f"portbench: reference check took {time.perf_counter() - t_check:.1f} s")

    result = {"correct": correct, "attempted": load.attempted,
              "failed": getattr(load, "failed", 0)}
    if traced:
        work = load.work()
        for k, b in work.items():
            print(f"portbench: work {k} per launch: {json.dumps(b)}", flush=True)
        ctx = Context(trace, win.spans, readings, work)
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(cell.root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak_reserved,
    }
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    if trace is None and traced and cuda:
        log("portbench: the profiler traced no device work")
    if result["failed"]:
        result["correct"] = False
    for name, c in compared.items():
        log(f"compared {name} = {c['value']} limit {c['limit']}")
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = pathlib.Path.cwd()
    from portbench import harness

    try:
        cell = harness.find_cell(root, args.workload)
    except (OSError, KeyError, ValueError) as e:
        log(f"portbench: {e}")
        return 2
    # every build and kernel cache of the run lives inside the checkout
    cache = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    try:
        import ray_tracing_tpu_torch
    except ImportError as e:
        log(f"portbench: the program is not here: {e}")
        return 4
    where = pathlib.Path(ray_tracing_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        log(f"portbench: the program loaded is {where}, not the checkout's")
        return 4
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = harness.forbidden_modules(sys.modules)
    if found:
        log(f"portbench: modules of JAX or the JAX package are loaded: {found}")
        return 5
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
