"""Share of the profiled slice's idle device time whose gaps' middles fall
in the port's "step.backward" span, in scene2.fit_invert: how much of the
idle card waits on autograd's backward. Read in the profiled slice, so it
carries the profiler's cost."""

from portbench.program_spans import idle_share_in


def read(ctx):
    return idle_share_in(ctx, "train_step", ("step.backward",))
