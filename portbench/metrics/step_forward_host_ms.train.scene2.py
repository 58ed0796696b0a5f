"""Host time per step in the port's "step.forward" span (the sharded render
of the step's frame, its autograd graph included), in scene2.train. Read in
the profiled slice, so it carries the profiler's cost: a traced frame took
15.4-18.9 ms against 10.3-14.7 untraced (PERF.md, section 7), and a step
pays it in each of its frames."""

from portbench.program_spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "train_step", ("step.forward",))
