"""K3's share of its roofline on these inputs, in scene2 cells, whose
device idles most of the window."""

from portbench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k3")
