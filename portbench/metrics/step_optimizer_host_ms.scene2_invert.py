"""Host time per step in the port's "step.optimizer" span (Adam's update of
p0), in scene2.fit_invert. Read in the profiled slice, so it carries the
profiler's cost."""

from portbench.program_spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "train_step", ("step.optimizer",))
