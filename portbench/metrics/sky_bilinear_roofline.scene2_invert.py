"""The bilinear sky compose kernel's share of its roofline on these inputs
(portbench/sky_work.py), in scene2.fit_invert. None where the trace holds
no launch of it."""

from portbench.sky_work import roofline_share


def read(ctx):
    return roofline_share(ctx, "sky_bilinear", "sky_compose_bilinear_kernel")
