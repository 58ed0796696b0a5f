"""The window's frame_ms, reported per layer: the host paces scene2.render
(its device idles most of the window), and its frame times spread too
widely from run to run to hold a bound."""

from portbench.readers import reading


def read(ctx):
    return reading(ctx, "frame_ms")
