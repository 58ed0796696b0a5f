"""Host time per step in the port's "soft_silhouettes" span (the composite
of the frame with the soft primary visibility: a trace of the primary rays,
a loop over the objects, the bilinear sky of the primary rays), in
scene2.fit_invert. None for a program that records no such span. Read in
the profiled slice, so it carries the profiler's cost."""

from portbench.program_spans import host_ms_per_unit, spans_of

NAMES = ("soft_silhouettes",)


def read(ctx):
    spans = spans_of(ctx, "train_step")
    if spans is None or not spans.outermost(NAMES):
        return None
    return host_ms_per_unit(ctx, "train_step", NAMES)
