"""Share of the profiled device window with nothing running, in
scene2.fit_invert, whose device idles most of the window."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
