"""Share of the profiled slice's idle device time whose gaps' middles fall
in the port's "sky_lookup" and "compose" spans, in scene2.render: how much
of the idle card waits on the host's sky lookup and compose. Read in the
profiled slice, so it carries the profiler's cost: a traced frame took
15.4-18.9 ms against 10.3-14.7 untraced (PERF.md, section 7)."""

from portbench.program_spans import idle_share_in


def read(ctx):
    return idle_share_in(ctx, "render_image", ("sky_lookup", "compose"))
