"""K2's share of its roofline on these inputs (the reference's counts of one
sample, portbench/kinds/invert_steps.py), in scene2.fit_invert, whose device
idles most of the window."""

from portbench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k2")
