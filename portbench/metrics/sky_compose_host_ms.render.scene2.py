"""Host time per frame in the port's "sky_lookup" and "compose" spans (each
sample's texel index, gather and unpack, compose_sky and the running sum),
in scene2.render, whose device idles most of the window. Read in the
profiled slice, so it carries the profiler's cost: a traced frame took
15.4-18.9 ms against 10.3-14.7 untraced (PERF.md, section 7)."""

from portbench.program_spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "render_image", ("sky_lookup", "compose"))
