"""Share of the profiled slice's idle device time whose gaps' middles fall
in the port's "step.backward" span, in scene2.train: how much of the idle
card waits on autograd's backward. Read in the profiled slice, so it carries
the profiler's cost: a traced frame took 15.4-18.9 ms against 10.3-14.7
untraced (PERF.md, section 7), and a step pays it in each of its frames."""

from portbench.program_spans import idle_share_in


def read(ctx):
    return idle_share_in(ctx, "train_step", ("step.backward",))
