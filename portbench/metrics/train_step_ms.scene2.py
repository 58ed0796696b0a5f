"""The window's train_step_ms, reported per layer: the host paces
scene2.train (its device idles most of the window), and its step times
spread too widely from run to run to hold a bound."""

from portbench.readers import reading


def read(ctx):
    return reading(ctx, "train_step_ms")
