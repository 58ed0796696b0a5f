"""Host time per step in the port's "step.backward" span (autograd's
backward: the soft silhouettes' plain backward, the sky compose adjoint and
the backward kernels' launches), in scene2.fit_invert. Read in the profiled
slice, so it carries the profiler's cost."""

from portbench.program_spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "train_step", ("step.backward",))
