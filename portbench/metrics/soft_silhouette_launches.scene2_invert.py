"""Kernel launches per step that the host issues inside the port's
"soft_silhouettes" span (the profiler's cudaLaunchKernel calls there): the
composite's plain ops, in scene2.fit_invert. None for a program that
records no such span. Read in the profiled slice."""

from portbench.program_spans import launches_per_unit, spans_of

NAMES = ("soft_silhouettes",)


def read(ctx):
    spans = spans_of(ctx, "train_step")
    if spans is None or not spans.outermost(NAMES):
        return None
    return launches_per_unit(ctx, "train_step", NAMES)
