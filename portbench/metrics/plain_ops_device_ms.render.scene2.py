"""Device time per frame of every kernel that is not a megakernel (sky
lookup, compose, average, uint8), in scene2 cells, whose device idles
most of the window."""

from portbench.readers import plain_ops_ms_per_unit


def read(ctx):
    return plain_ops_ms_per_unit(ctx)
