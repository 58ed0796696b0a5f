"""Kernel launches per frame that the host issues inside the port's
"sky_lookup" and "compose" spans (the profiler's cudaLaunchKernel calls
there): the plain ops' launch count, in scene2.render. Read in the profiled
slice, so it carries the profiler's cost: a traced frame took 15.4-18.9 ms
against 10.3-14.7 untraced (PERF.md, section 7)."""

from portbench.program_spans import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, "render_image", ("sky_lookup", "compose"))
