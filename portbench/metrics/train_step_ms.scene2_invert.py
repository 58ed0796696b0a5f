"""The window's train_step_ms in scene2.fit_invert, reported per layer: the
host paces the cell (a 96x64 step is a few hundred launches and little
device work), and its step times spread too widely from run to run to hold
a bound."""

from portbench.readers import reading


def read(ctx):
    return reading(ctx, "train_step_ms")
