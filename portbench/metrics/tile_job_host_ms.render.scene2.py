"""Host time per frame in the port's "tile_job" span (effective_bwd_mode,
make_tile_job and the scene's, camera's and sky's .to(device)), in
scene2.render, whose device idles most of the window. Read in the profiled
slice, so it carries the profiler's cost: a traced frame took 15.4-18.9 ms
against 10.3-14.7 untraced (PERF.md, section 7)."""

from portbench.program_spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "render_image", ("tile_job",))
