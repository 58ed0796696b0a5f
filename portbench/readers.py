"""What the per-layer metric files (portbench/metrics/<name>.py) share:
each file is one `read(ctx)` that calls one of these on the run's Context
(run.py). A reader that finds nothing to read returns None, and the metric
is left out of the line."""

from __future__ import annotations


def megakernel(name: str) -> str | None:
    """Which of the port's megakernels a device op is, by its name: k1 and
    k2 are fwd_kernel<false> and <true>, k3-k5 bwd_kernel over the fetched,
    recorded and traced winners; None for any other op."""
    if "fwd_kernel" in name:
        return "k2" if ("<true>" in name or "ILb1E" in name) else "k1"
    if "bwd_kernel" in name:
        for kid, winners in (("k3", "FetchWinners"), ("k4", "RecordedWinners"),
                             ("k5", "TracedWinners")):
            if winners in name:
                return kid
    return None


def span_mean_ms(ctx, name: str):
    """Mean host time of the benchmark's span `name` per unit, outside the
    profiled slice, in ms."""
    v = ctx.spans.get(name)
    return sum(v) / len(v) * 1e3 if v else None


def launches_per_unit(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    return len(t.kernels()) / t.units


def plain_ops_ms_per_unit(ctx):
    """Device time per unit of every kernel that is not a megakernel."""
    t = ctx.trace
    if t is None or not t.units:
        return None
    return t.seconds(t.kernels(lambda n: megakernel(n) is None)) / t.units * 1e3


def roofline_share(ctx, kid: str):
    """The least time the card could take for the traced launches of
    megakernel `kid` (launches times roofline.py's bound for one) over the
    device time they took, in %. None where the trace holds no such launch."""
    t = ctx.trace
    if t is None or kid not in ctx.work:
        return None
    ops = t.kernels(lambda n: megakernel(n) == kid)
    if not ops:
        return None
    return len(ops) * ctx.work[kid]["bound_s"] / t.seconds(ops) * 100.0


def idle_share(ctx):
    """Share of the traced device window in which no kernel, copy or fill
    ran, in %."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0


def reading(ctx, name: str):
    """An end-to-end reading of the window, for a cell where it is reported
    per layer."""
    return ctx.readings.get(name)
