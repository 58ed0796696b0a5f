"""Share of the profiled device window with nothing running, in
objects1024.render, whose K1 launches trace 1,024 objects a ray."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
