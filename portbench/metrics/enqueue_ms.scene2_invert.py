"""The host's time in the train step's call (forward, backward(),
optimizer.step()), per step, in scene2.fit_invert, whose device idles most
of the window."""

from portbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "step")
