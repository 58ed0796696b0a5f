"""K3's share of its roofline on these inputs (the reference's counts of one
sample, portbench/kinds/invert_steps.py), in scene2.fit_invert, whose device
idles most of the window. K3 takes the bilinear sky's direction cotangents
here."""

from portbench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k3")
