"""Kernel launches per frame in the profiled slice, in scene2 cells, whose
device idles most of the window."""

from portbench.readers import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx)
